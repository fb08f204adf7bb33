"""The benchmark of slb2d_tpu_torch: one cell of BENCHMARK.json on CUDA.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up (Python, torch, the card, the kernel library and one warm request
of the cell's shapes) is timed as setup_s; then the window runs the
cell's requests back to back for --seconds seconds, one client, and the
sampled answers are compared with the plain reference.  The last line of
standard output is one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer metrics
from torch.profiler's trace of the window), device, with --trace 1
breakdown, and last the numbers compared beside their limits, which also
close standard error.

Without a CUDA device, with fewer than the cell's chips, or when JAX or
the JAX package was loaded, it prints no result and exits non-zero.
"""

import time

T_ORIGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

from harness import check, spec, trace as tracemod, window  # noqa: E402


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(chips, rec):
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}
    if rec.trace is not None:
        info["busy_s"] = rec.trace.busy_s
        info["window_s"] = rec.trace.window_s
    return info


def result(cell, rec, trace_on, device, checks):
    """The result's dict, its checks last."""
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    correct = (not any(r["failed"] for r in rec.requests)
               and all(limits.get(k) is not None and v <= limits[k]
                       for k, v in checks.items()))
    out = {"correct": bool(correct), "attempted": len(rec.requests),
           "failed": sum(r["failed"] for r in rec.requests),
           "metrics": metrics, "device": device}
    if rec.trace is not None:
        out["breakdown"] = tracemod.breakdown(rec.trace)
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in checks.items()}
    return out


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        log("run.py: no CUDA device; the benchmark runs on a card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"run.py: {args.workload} needs {cell.chips} CUDA devices, "
            f"have {torch.cuda.device_count()}")
        return 2
    rec = window.measure(cell, args.seed, args.seconds,
                         profile=bool(args.trace), t_origin=T_ORIGIN)
    device = device_info(cell.chips, rec)
    banned = window.banned_modules()
    if banned:
        log(f"run.py: the window loaded {', '.join(banned)}; no result")
        return 3
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check.compare(rec, args.seed, "cuda")
    log(f"# reference compared in {time.perf_counter() - t0:.1f} s")
    out = result(cell, rec, bool(args.trace), device, checks)
    banned = window.banned_modules()
    if banned:
        log(f"run.py: the run loaded {', '.join(banned)}; no result")
        return 3
    for k, v in out["checks"].items():
        log(f"check {k} = {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
