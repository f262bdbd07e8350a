"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one run of
one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program under ``src/``.  The cell
names a configuration (``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<name>.json``); the mix's ``kind`` names the driver
(``portbench/harness/<kind>.py``) that sets the cell up, measures it for
``--seconds`` and checks what the timed path produced against the plain
reference (``portbench/reference/``).  Each metric is read by
``portbench/metrics/<metric>.py``: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a run under
``torch.profiler``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the same checks end standard error.  Without the cards the cell asks for,
without the program, or with JAX or the JAX package loaded, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names the run may not load: JAX, its libraries, and the
# JAX package the port was made from (compared whole: ``repro_torch`` is fine)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (by default the modules
    this process has loaded)."""
    names = list(sys.modules if names is None else names)
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library may load JAX on its own."""
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(bench, cell, rec, trace: bool) -> dict:
    """The result's JSON object for the run record ``rec``."""
    from portbench.harness import manifest

    wanted = manifest.per_layer_of(bench, cell.name) if trace else manifest.end_to_end_of(bench, cell.name)
    metrics = {}
    for m in wanted:
        value = manifest.reader(m.name)(rec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    line = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
            "metrics": metrics, "device": dict(rec.device)}
    if trace and rec.trace is not None:
        line["device"]["busy_s"] = rec.trace["busy_s"]
        line["device"]["window_s"] = rec.trace["window_s"]
        line["breakdown"] = rec.trace["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in rec.checks}
    return line


def measure(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            config: Optional[dict] = None, traffic: Optional[dict] = None):
    """One run of ``workload`` on ``device``: ``(result line, run record)``.
    ``config`` and ``traffic`` replace the files' contents (the tests'
    rehearsals at a small size on the CPU)."""
    from portbench.harness import manifest

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, workload)
    config = config if config is not None else manifest.config(cell.config)
    traffic = traffic if traffic is not None else manifest.traffic(cell.traffic)
    driver = importlib.import_module("portbench.harness." + traffic["kind"])
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        rec = driver.run(config, traffic, seed % (1 << 63), seconds, trace, workdir, device, CLOCK0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return result_line(bench, cell, rec, trace), rec


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from portbench.harness import devices, manifest

    cell = manifest.cell(manifest.load(ROOT), args.workload)
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"portbench: no program under {src}; nothing is measured", file=sys.stderr)
        return 4
    sys.path.insert(0, src)
    devices.require_cards(cell.chips)
    line, rec = measure(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 5
    for name, what in rec.notes:
        print(f"note {name} {what}", file=sys.stderr)
    for c in rec.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
