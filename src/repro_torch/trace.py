"""``python -m repro_torch.trace run.json`` — inspect / convert a saved trace.

``Tracer.save(path)`` writes the repro-trace JSON format; this CLI prints a
per-span-name summary table and (with ``--chrome OUT``) converts the file to
the Chrome-trace/Perfetto event-array format, loadable in ``ui.perfetto.dev``
or ``chrome://tracing``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.obs.trace import Span, chrome_trace, load_trace


def summarize(roots: List[Span]) -> str:
    """Per-name count / total / mean milliseconds over the whole tree."""
    agg: dict = {}
    for root in roots:
        for sp in root.walk():
            cnt, tot = agg.get(sp.name, (0, 0.0))
            agg[sp.name] = (cnt + 1, tot + sp.duration_s)
    width = max([len(n) for n in agg] + [4])
    lines = [f"{'span':<{width}}  {'count':>7}  {'total_ms':>10}  {'mean_ms':>9}"]
    for name in sorted(agg, key=lambda n: -agg[n][1]):
        cnt, tot = agg[name]
        lines.append(
            f"{name:<{width}}  {cnt:>7}  {tot * 1e3:>10.3f}  "
            f"{tot * 1e3 / cnt:>9.3f}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description="summarize a saved repro trace; optionally emit "
        "Chrome-trace/Perfetto JSON",
    )
    ap.add_argument("path", help="trace file written by Tracer.save()")
    ap.add_argument(
        "--chrome",
        metavar="OUT",
        default=None,
        help="write the Chrome-trace event array to OUT ('-' for stdout)",
    )
    args = ap.parse_args(argv)

    roots = load_trace(args.path)
    if args.chrome is not None:
        payload = chrome_trace(roots)
        if args.chrome == "-":
            json.dump(payload, sys.stdout)
            sys.stdout.write("\n")
        else:
            with open(args.chrome, "w") as f:
                json.dump(payload, f)
            print(f"wrote {len(payload['traceEvents'])} events -> {args.chrome}")
    if not roots:
        print("empty trace")
        return 0
    print(f"{args.path}: {len(roots)} root span(s)")
    print(summarize(roots))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
