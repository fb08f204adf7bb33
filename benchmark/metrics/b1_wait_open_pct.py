"""b1_wait_open_pct: of B1's resident-form waits at its grid barrier in
the traced window (one a band and step), the share whose first read found
the barrier already open, every band's edges of the step before already
out, in %: 100 x b1.waits_open / b1.waits, the program's counters
(slb2d_tpu_torch.tracing), which grow only while spans are recorded, so
only in the traced window.  None without a trace, or where the program
keeps no such counter (a program whose resident form waits at a grid
barrier of cooperative groups)."""


def read(rec):
    if rec.trace is None:
        return None
    try:
        from slb2d_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    waits = counts.get("b1.waits", 0)
    if waits <= 0:
        return None
    return 100.0 * counts.get("b1.waits_open", 0) / waits
