"""idle_untraced_ms: the device's idle time in the traced window (the gaps
device_idle_pct reads: no kernel, copy or set running) during which no
program span below the request level is open on any thread, in ms per
request.  The request-level spans (sim.init, sim.run, sweep.init,
sweep.run) hold every other span of a request, so a moment is untraced
where no other span of the program (slb2d_tpu_torch.tracing, on the
trace's clock) covers it: the harness's own time between requests, and
host time inside a request that no span names.  A clock the spans do not
share with the trace shows here too.  None without a trace, or where the
program records no span."""

from harness.spans import program_spans
from harness.trace import idle_gaps

REQUEST_LEVEL = ("sim.init", "sim.run", "sweep.init", "sweep.run")


def _union(intervals):
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def untraced_us(gaps, named):
    """The part of the disjoint sorted gaps that no interval of `named`
    covers, in the intervals' unit."""
    cover = _union(named)
    total, j = 0.0, 0
    for gs, ge in gaps:
        left = ge - gs
        while j < len(cover) and cover[j][1] <= gs:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < ge:
            left -= min(cover[k][1], ge) - max(cover[k][0], gs)
            k += 1
        total += left
    return total


def read(rec):
    t = rec.trace
    if t is None or not rec.done:
        return None
    spans = program_spans()
    if not spans:
        return None
    lo, hi = t.window
    busy = [(s, e) for _, s, e in t.clipped(t.kernels + t.copies)]
    named = [(s.start_ns * 1e-3, s.end_ns * 1e-3) for s in spans
             if s.name not in REQUEST_LEVEL]
    return 1e-3 * untraced_us(idle_gaps(busy, lo, hi), named) / len(
        rec.done)
