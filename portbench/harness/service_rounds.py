"""Traffic kind ``service_rounds``: data scientists sharing one service.

Set-up draws the configuration's table from the seed, writes it into a
lake, and runs one round to warm every shape the window uses.  A round is
a fresh ``PipelineService`` over that lake (the configuration's workers and
spill tier, one ``DeviceTier`` behind both shared stores: empty caches, an
empty tier): the traffic's ``fill`` edit runs alone, then every tenant runs
its own script concurrently, each in a closed loop (it submits its next
edit when the last has finished).  The window runs whole rounds until
``seconds`` have passed; the round under way at that moment is finished.
The service is shut down without parking its caches in the spill tier, so
no round writes more than the lake.

Correctness: every round of the window keeps the outputs of a
sample drawn from the seed, the fill and one edit of each tenant, and
compares none of them.  Once the window has closed, the first round's are
compared bitwise with the plain NumPy recomputation, and every later
round's with the first round's.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Any, Dict, List

import numpy as np

from portbench.harness import devices, lake, project
from portbench.harness.edit_sessions import KEPT, UnionCounter, outputs_of, windows_of
from portbench.harness.record import Check, Run
from portbench.harness.trace import DeviceTrace, program_spans


def run(config: Dict[str, Any], traffic: Dict[str, Any], seed: int, seconds: float,
        trace: bool, workdir: str, device: str, clock0: float) -> Run:
    import torch
    from repro_torch.core.columnar import Table
    from repro_torch.core.device import DeviceTier
    from repro_torch.kernels.fragment_gather import kernel
    from repro_torch.obs.trace import Tracer
    from repro_torch.service import DONE, PipelineService

    from portbench.reference.fhvhv_iterate import expected, mismatches

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rows, frag = int(config["rows"]), int(config["rows_per_fragment"])
    key, table = config["sort_key"], config["table"]
    svc_cfg = config["service"]
    tier_bytes = config.get("device_tier", {}).get("max_bytes")
    fill = traffic["fill"]
    tenants = traffic["tenants"]
    out = Run("service_rounds", config, traffic)
    columns = lambda edit: list(traffic["base_columns"]) + list(edit["columns"])

    # -- set-up: the lake, then one round to warm every shape
    raw = lake.table(config, seed, rows)
    root = os.path.join(workdir, "lake")
    with PipelineService(root, workers=1, rows_per_fragment=frag, torch_device=device) as writer:
        ns, name = table.rsplit(".", 1)
        writer.catalog.create_table(ns, name, lake.schema(config), key)
        writer.catalog.append(table, Table(raw))
    wanted = {key} | {c for t in tenants for e in t["script"] for c in columns(e)} | set(columns(fill["edit"]))
    raw = {c: v for c, v in raw.items() if c in wanted}
    tracer = Tracer()

    def proj(edit):
        return project.trips_project(table, key, windows_of(config, edit["days"]), columns(edit), edit["gain"])

    def one_round(index: int, sample: Dict[str, int], stats=None) -> Dict:
        svc = PipelineService(root, workers=svc_cfg["workers"], rows_per_fragment=frag,
                              spill=svc_cfg["spill"], tracer=tracer, torch_device=device)
        svc.scan_cache.device = svc.model_store.device = DeviceTier(max_bytes=tier_bytes, device=device)
        got: Dict[str, Any] = {}
        lock = threading.Lock()

        def edit_run(tenant: str, e: int, edit) -> None:
            t = time.perf_counter()
            h = svc.submit(tenant, proj(edit)).wait()
            sync()
            wall = time.perf_counter() - t
            if h.state != DONE:
                raise h.error or RuntimeError(f"{tenant} edit {e} ended {h.state}")
            res = h.result
            record = {"session": index, "tenant": tenant, "label": edit["label"], "wall_s": wall,
                      "bytes_from_cache": int(res.bytes_from_cache),
                      "bytes_from_model_cache": int(res.bytes_from_model_cache),
                      "bytes_from_store": int(res.bytes_from_store)}
            with lock:
                if stats is not None:
                    stats.append(record)
                if sample.get(tenant) == e or e < 0:
                    got[(tenant, e)] = outputs_of(res)

        def tenant_loop(t) -> None:
            for e, edit in enumerate(t["script"]):
                edit_run(t["name"], e, edit)

        before = svc.store.stats.snapshot()
        edit_run(fill["tenant"], -1, fill["edit"])
        errors: List[BaseException] = []

        def guarded(t):
            try:
                tenant_loop(t)
            except BaseException as err:  # re-raised on the round's thread
                errors.append(err)

        threads = [threading.Thread(target=guarded, args=(t,), name=f"tenant-{t['name']}") for t in tenants]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        d = svc.store.stats.delta(before)
        svc.shutdown(wait=False)
        del svc
        gc.collect()
        if errors:
            raise errors[0]
        return {"outputs": got, "gets": d.get_requests, "bytes": d.bytes_read}

    one_round(-1, sample={})
    sync()
    out.setup_s = time.perf_counter() - clock0

    # -- the window
    rng = np.random.default_rng([seed, 1])
    launches0 = kernel.launches
    prof = DeviceTrace() if trace else None
    tracer.clear()
    with UnionCounter() as unions:
        if prof is not None:
            prof.start()
        sample = {t["name"]: int(rng.integers(len(t["script"]))) for t in tenants}
        t0 = time.perf_counter()
        first = one_round(0, sample, stats=out.edits)
        rounds = [first]
        while time.perf_counter() - t0 < seconds:
            rounds.append(one_round(len(rounds), sample, stats=out.edits))
        out.window_s = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
    out.store_gets = sum(r["gets"] for r in rounds)
    out.store_bytes = sum(r["bytes"] for r in rounds)
    out.union_launches = kernel.launches - launches0
    out.union_bytes = unions.bytes
    out.attempted = len(out.edits)
    out.device = devices.describe(1, torch.device(device).type)
    if prof is not None:
        out.trace = prof.summary(program_spans(tracer.roots()))

    # -- correctness, once the window has closed
    kept = first["outputs"]
    later = [sum(mismatches(got[n], kept[te][n]) for n in KEPT)
             for r in rounds[1:] for te, got in r["outputs"].items()]
    del rounds, first
    worst, bad = sum(later), sum(1 for m in later if m)
    scripts = {t["name"]: t["script"] for t in tenants}
    for (tenant, e), got in kept.items():
        edit = fill["edit"] if e < 0 else scripts[tenant][e]
        want = expected(raw, key, windows_of(config, edit["days"]), columns(edit), edit["gain"])
        m = sum(mismatches(got[n], want[n]) for n in KEPT)
        bad += m > 0
        worst += m
    out.failed = bad
    out.checks.append(Check("mismatched_values", float(worst), 0.0))
    return out
