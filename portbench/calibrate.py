"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size.  The benchmark's runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--controls 3]

For a ``pretrain`` cell, each seed is one run of the cell with an empty
window: the program's first steps against the plain float32 reference,
the numbers its check compares (the lower readings).  For the first
``--controls`` seeds, the reference is then put in the program's place
twice more and held against the float32 one: computed in float8 (the
control, one precision below the configuration's bfloat16), and with half
of each batch left out (a fault).  For an ``edit_sessions`` or ``service_rounds`` cell, each of
the first ``--controls`` seeds compares the control (the reference's
``feats`` computed in float16) with the reference over every edit of the
script (of every tenant's, for ``service_rounds``).  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def pretrain(workload: str, seed: int, control: bool, device: str = "cuda", **sizes) -> dict:
    import torch

    from portbench.harness import corpus, weights
    from portbench.harness.pretrain import corpus_steps
    from portbench.reference.granite import gaps, train_steps
    from portbench.run import measure

    _line, rec = measure(workload, seed, 0.0, False, device, **sizes)
    out = {"seed": seed, "program": {c.name: c.value for c in rec.checks}}
    if control:
        config, traffic = rec.config, rec.traffic
        notes = dict(rec.notes)
        count = corpus_steps(config, traffic, 0.0) * traffic["global_batch"] * (traffic["seq_len"] + 1)
        data = corpus.tokens(seed % (1 << 63), count,
                             config["vocab_size"], traffic["mean_doc_len"], traffic["eos_id"])
        batches = [corpus.batch(data, i, traffic["global_batch"], traffic["seq_len"])
                   for i in range(traffic["checked_steps"])]
        dtype = getattr(torch, config["training"]["dtype"])
        names = [n for n, _s, _f in weights.leaves(config)]
        initial = lambda n: weights.draw(config, seed % (1 << 63), n, device, dtype)
        opt = config["training"]["optimizer"]
        fp8 = train_steps(config, opt, initial, names, batches, device, precision="fp8")
        out["control_fp8"] = gaps(fp8, notes["reference"])
        del fp8
        half = train_steps(config, opt, initial, names, batches, device, rows=[0])
        out["half_batch"] = gaps(half, notes["reference"])
    return out


def edits(workload: str, seed: int) -> dict:
    from portbench.harness import lake, manifest
    from portbench.reference.fhvhv_iterate import expected, mismatches

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, workload)
    config, traffic = manifest.config(cell.config), manifest.traffic(cell.traffic)
    raw = lake.table(config, seed % (1 << 63), int(config["rows"]))
    edits = traffic.get("script") or [traffic["fill"]["edit"]] + [e for t in traffic["tenants"] for e in t["script"]]
    per_edit = []
    for edit in edits:
        windows = [(lake.key_of_day(config, lo), lake.key_of_day(config, hi)) for lo, hi in edit["days"]]
        cols = list(traffic["base_columns"]) + list(edit["columns"])
        want = expected(raw, config["sort_key"], windows, cols, edit["gain"])
        got = expected(raw, config["sort_key"], windows, cols, edit["gain"], precision="float16")
        per_edit.append(sum(mismatches(got[n], want[n]) for n in want))
    return {"seed": seed, "control_float16": {"mismatched_values": sum(per_edit)}, "per_edit": per_edit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    from portbench.harness import manifest

    bench = manifest.load(ROOT)
    kind = manifest.traffic(manifest.cell(bench, args.workload).traffic)["kind"]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        if kind == "pretrain":
            row = pretrain(args.workload, seed, i < args.controls)
        elif i < args.controls:
            row = edits(args.workload, seed)
        else:
            continue
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
