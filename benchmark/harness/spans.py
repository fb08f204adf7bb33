"""The program's spans (slb2d_tpu_torch.tracing: ns on the trace's clock)
in a traced window, for the readers of metrics/ that sum them."""


def program_spans():
    """Every span the program recorded, or None from a program without
    the recorder."""
    try:
        from slb2d_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def span_ms(rec, name, less=()):
    """The host time of the program's `name` spans inside rec's traced
    window, less that of their child spans named in `less`, in ms; None
    without a trace or without such a span."""
    t = rec.trace
    spans = None if t is None else program_spans()
    if not spans:
        return None
    lo, hi = t.window

    def inside_us(s):
        return max(0.0, min(s.end_ns * 1e-3, hi) - max(s.start_ns * 1e-3, lo))
    mine = [s for s in spans if s.name == name
            and s.end_ns * 1e-3 > lo and s.start_ns * 1e-3 < hi]
    if not mine:
        return None
    ids = {s.id for s in mine}
    us = sum(map(inside_us, mine)) - sum(
        inside_us(s) for s in spans if s.name in less and s.parent in ids)
    return 1e-3 * us
