"""The readings that a cell's limit is set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--control S1 S2 S3]

For each seed: the cell's warm-up and its first request at the cell's
own sizes, the check's sample of its answers, and the gap of the program
against the reference (the lower reading).  For each --control seed also
the control: the reference itself in bfloat16 (the precision below the
configurations' float32) in the program's place on the same sample, and
its gap against the reference at the configuration's precision (the
upper reading).  One JSON line a seed on standard output; the benchmark's
own runs never run this.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

from harness import check, spec, window  # noqa: E402
from reference.solver import D77_OBSERVABLES, OBSERVABLES  # noqa: E402


def per_column(got, ref, columns):
    """The worst gap of each observable over the rows."""
    out = {}
    for col in columns:
        out[col] = max(abs(float(p[col]) - float(r[col]))
                       / max(abs(float(r[col])), check.FLOOR)
                       for p, r in zip(got, ref))
    return out


# the precision below the configurations' float32
CONTROL_DTYPE = "bfloat16"


def readings(cell, seed, device, control=False, extra=None):
    """{program gap, per column; control gap, per column} for one seed."""
    import torch
    control_dtype = CONTROL_DTYPE if control else None
    rec = window.measure(cell, seed, 0.0, extra=extra,
                         log=lambda msg: None)
    out = {"seed": seed, "requests": len(rec.requests),
           "failed": sum(r["failed"] for r in rec.requests)}
    worst, cols = 0.0, {}
    ctl, ctl_cols = 0.0, {}
    for idx, pts in check.sample(rec, seed):
        req = rec.reqs[idx]
        t0 = time.perf_counter()
        ref = check.reference_rows(req, pts, device)
        out["reference_s"] = time.perf_counter() - t0
        columns = D77_OBSERVABLES if check.series(req) else OBSERVABLES
        got = (rec.rows(idx) if check.series(req)
               else [rec.rows(idx)[j] for j in pts])
        if check.series(req):
            out["lines"] = [len(got), len(ref)]
        worst = max(worst, check.gap(got, ref, columns))
        cols = per_column(got, ref, columns)
        if control_dtype is not None:
            low = check.reference_rows(req, pts, device,
                                       getattr(torch, control_dtype))
            ctl = max(ctl, check.gap(low, ref, columns))
            ctl_cols = per_column(low, ref, columns)
    out.update(gap=worst, columns=cols)
    if control_dtype is not None:
        out.update(control_gap=ctl, control_columns=ctl_cols,
                   control_dtype=control_dtype)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        r = readings(cell, seed, "cuda", seed in args.control)
        r["workload"] = args.workload
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
