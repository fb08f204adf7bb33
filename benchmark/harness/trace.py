"""The device's activity in a traced window, from torch.profiler's trace.

The trace is read whole, whatever the kernels are named: every device
kernel, memory copy and memory set is an interval; the harness's spans are
the CPU ranges named "slbbench:<span>".  Device-side copies of those
ranges (the profiler's GPU user annotations) are not device work and are
left out.
"""

from __future__ import annotations

import dataclasses

from .drive import SPAN_PREFIX


@dataclasses.dataclass
class Trace:
    kernels: list         # (name, start_us, end_us) of every kernel
    copies: list          # (name, start_us, end_us) of memcpy and memset
    spans: list           # (name, start_us, end_us) of the harness's spans
    window: tuple         # (start_us, end_us): first request to last

    def clipped(self, items):
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in items
                if e > lo and s < hi]

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self):
        """Seconds of the window in which a kernel, copy or set ran."""
        return union_seconds([(s, e) for _, s, e in
                              self.clipped(self.kernels + self.copies)])


def union_seconds(intervals):
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


def idle_gaps(busy, lo, hi):
    """The (start_us, end_us) gaps of [lo, hi] that no busy interval
    covers."""
    gaps, at = [], lo
    for s, e in sorted(busy):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def _is_copy(name):
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _events(prof):
    """(name, is_device, start_us, end_us) of every event of the trace,
    from the profiler's raw kineto events."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-3
        yield (e.name(), e.device_type() == DeviceType.CUDA, s,
               s + e.duration_ns() * 1e-3)


def from_profiler(prof):
    """A Trace of a finished torch.profiler.profile over the window."""
    kernels, copies, spans = [], [], []
    for name, on_device, s, t in _events(prof):
        if on_device:
            if name.startswith(SPAN_PREFIX):
                continue
            (copies if _is_copy(name) else kernels).append((name, s, t))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], s, t))
    req = [(s, t) for n, s, t in spans if n in ("build", "run")]
    window = (min(s for s, _ in req), max(t for _, t in req)) if req else (
        0.0, 0.0)
    return Trace(kernels, copies, spans, window)


def breakdown(trace, top=10):
    """The device operations that took most time, by name, and the idle
    time of the window by the harness span open at the time."""
    by_op = {}
    for name, s, e in trace.clipped(trace.kernels + trace.copies):
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    busy = [(s, e) for _, s, e in trace.clipped(trace.kernels
                                                 + trace.copies)]
    lo, hi = trace.window
    spans = sorted((s, e, n) for n, s, e in trace.spans)
    by_span = {}
    for gs, ge in idle_gaps(busy, lo, hi):
        # split the gap over the spans it meets; the rest is the
        # harness's own time between requests
        left = ge - gs
        for s, e, n in spans:
            if e <= gs or s >= ge:
                continue
            part = min(e, ge) - max(s, gs)
            by_span[n] = by_span.get(n, 0.0) + part * 1e-6
            left -= part
        if left > 0:
            by_span["between requests"] = (by_span.get("between requests",
                                                       0.0) + left * 1e-6)
    gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[f"idle in {n}", v] for n, v in gaps]}
