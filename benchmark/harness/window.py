"""A run of one cell: set-up, the warm-up request, the measured window,
and the record the metric readers read.

The window is a closed loop with one client: the next request starts when
the last one has ended, for as long as the window lasts.  It starts with
the first request and ends with the last one; a request started before
the window's time is up runs to its end, and there is always one.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

from . import drive, roofline, trace as tracemod, traffic as trafficmod

# top-level module names that no run may load: JAX and the JAX package
# (compared whole, so the port's package passes)
BANNED = ("jax", "jaxlib", "flax", "slb2d_tpu")


@dataclasses.dataclass
class Record:
    cell: object
    requests: list            # dicts, one a request of the window
    outputs: dict             # request index -> rows() of its answers
    reqs: dict                # request index -> its Request
    setup_s: float
    window_s: float
    trace: object = None      # a trace.Trace under --trace 1
    collections: list = dataclasses.field(default_factory=list)
    # (generation, start, end) of each of the garbage collector's passes
    # in the window, on the requests' clock

    @property
    def done(self):
        return [r for r in self.requests if not r["failed"]]

    def rows(self, index):
        """The program's rows of a request, read once the window is over."""
        got = self.outputs[index]
        if callable(got):
            got = self.outputs[index] = got()
        return got


def banned_modules(modules=None):
    """The loaded modules whose top-level name is in BANNED."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def _work(req, N, M, itemsize):
    """(sites, flops, bytes) of a request, counted from its sizes."""
    P = req.n_points
    return (2 * (N + 1) * (M + 1) * req.steps * P,
            roofline.flops(N, M, req.steps, P, req.av_steps,
                           captures=req.captures, chains=req.chains),
            roofline.nbytes(N, M, req.steps, P, itemsize))


def _sync():
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(cell, seed, seconds, profile=False, t_origin=None, extra=None,
            log=None):
    """Warm up, then run the window; returns its Record.  extra: settings
    added to every request (device=cpu in the tests)."""
    t_origin = time.perf_counter() if t_origin is None else t_origin
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    config, traffic = cell.config, cell.traffic
    N, M = int(config["args"]["n-harmonics"]), int(config["args"]["g-grid"])
    itemsize = 8 if config["args"].get("dtype") == "f64" else 4

    # set-up: the program's first use (the kernel library, the card), one
    # warm request of the cell's shapes
    warm = trafficmod.warm_request(config, traffic, seed, extra)
    drive.run_request(warm, drive.Spans())
    _sync()
    log(f"# warm request: {warm.steps} steps, {warm.n_points} point(s)")

    gen = trafficmod.requests(config, traffic, seed, extra)
    spans = drive.Spans(profiled=profile)
    requests, outputs, reqs = [], {}, {}
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as profiler
        acts = [ProfilerActivity.CPU]
        import torch
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profiler(activities=acts)
        prof.__enter__()
    collections, gc_open = [], {}

    def on_gc(phase, info):
        if phase == "start":
            gc_open["t"] = time.perf_counter()
        elif "t" in gc_open:
            collections.append((info["generation"], gc_open.pop("t"),
                                time.perf_counter()))

    gc.callbacks.append(on_gc)
    t_win = time.perf_counter()
    setup_s = t_win - t_origin
    try:
        while not requests or time.perf_counter() - t_win < seconds:
            req = next(gen)
            n0 = len(spans.items)
            t0 = time.perf_counter()
            failed = False
            try:
                outputs[req.index] = drive.run_request(req, spans)
            except Exception as e:     # a request that fails is counted
                failed = True
                log(f"# request {req.index} failed: {type(e).__name__}: {e}")
            t1 = time.perf_counter()
            sites, flops, nbytes = _work(req, N, M, itemsize)
            took = {n: e - s for n, s, e in spans.items[n0:]}
            requests.append(dict(
                index=req.index, entry=req.entry, start=t0, end=t1,
                steps=req.steps, sites=sites, flops=flops, bytes=nbytes,
                failed=failed, build_s=took.get("build")))
            reqs[req.index] = req
    finally:
        gc.callbacks.remove(on_gc)
        if prof is not None:
            _sync()
            prof.__exit__(None, None, None)
    window_s = requests[-1]["end"] - requests[0]["start"]
    lo, hi = requests[0]["start"], requests[-1]["end"]
    rec = Record(cell, requests, outputs, reqs, setup_s, window_s,
                 collections=[c for c in collections
                              if c[1] >= lo and c[2] <= hi])
    walls = sorted(r["end"] - r["start"] for r in requests)
    builds = sorted(r["build_s"] for r in requests if r["build_s"])
    log(f"# window {window_s:.3f} s, {len(requests)} requests: wall "
        f"min {walls[0]:.4f} median {walls[len(walls) // 2]:.4f} max "
        f"{walls[-1]:.4f} s; build median "
        f"{builds[len(builds) // 2] if builds else 0:.4f} max "
        f"{builds[-1] if builds else 0:.4f} s; {len(rec.collections)} "
        f"collections, {sum(1 for c in rec.collections if c[0] == 2)} full, "
        f"{sum(e - s for _, s, e in rec.collections):.3f} s")
    if prof is not None:
        t0 = time.perf_counter()
        rec.trace = tracemod.from_profiler(prof)
        tr = rec.trace
        log(f"# trace read in {time.perf_counter() - t0:.1f} s: "
            f"{len(tr.kernels)} kernels ({len(tr.clipped(tr.kernels))} in "
            f"the window of {tr.window_s:.3f} s), {len(tr.copies)} copies "
            f"and sets, {len(tr.spans)} spans")
    return rec
