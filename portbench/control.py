"""The readings the check's limits are set from, for many seeds in one
process (``python -m portbench.control --workload <cell> --seeds ...``).

For each seed: the program's set-up (a training cell's first three steps,
or one scoring of every pool batch at the cell's own batch) against the
reference, which gives the lower reading of each number; the control,
the reference with its products in float8 put in the program's place,
which has to read over the limit; and, in training, the fault "half of
the batch left out, the mean taken over the rest", planted in the
reference put in the program's place. A state left unchanged reads 1
in ``change_gap`` and needs no run. Each seed prints one JSON line; the
last line is the summary: each number's largest program reading and the
control's and the fault's smallest.
"""

import argparse
import json
import sys
import time

import torch

from portbench import check, harness, registry


def readings(cell, seed: int, device="cuda") -> dict:
    run = harness.setup(cell, seed, device)
    if not run.train:
        with torch.inference_mode():
            for _ in range(len(run.pool)):
                run.advance()
        harness.sync(run.device)
    got = harness.release(run)
    ref = harness.reference_readings(run, run.a.compute_dtype)
    out = {"seed": seed, "program": harness.numbers(run, got, ref),
           "worst_leaf": check.worst_leaves(got, ref) if run.train else {},
           "control": harness.numbers(
               run, harness.reference_readings(run, "float8"), ref)}
    if run.train:
        out["half_batch"] = harness.numbers(run, harness.reference_readings(
            run, run.a.compute_dtype, run.pool.half()), ref)
    return out


def summary(rows) -> dict:
    keys = rows[0]["program"]
    out = {"lower": {k: max(r["program"][k] for r in rows) for k in keys},
           "control": {k: min(r["control"][k] for r in rows) for k in keys}}
    if "half_batch" in rows[0]:
        out["half_batch"] = {k: min(r["half_batch"][k] for r in rows)
                             for k in keys}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = registry.load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        rows.append(readings(cell, seed, "cuda"))
        rows[-1]["seconds"] = time.perf_counter() - t
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": cell.name, "seeds": args.seeds,
                      **summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
