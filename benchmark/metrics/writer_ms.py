"""writer_ms: the host time the single runs' writers took in the traced
window (the display-4 line, a chunk's display-77 records): the program's
io.write spans (slb2d_tpu_torch.tracing, on the trace's clock) clipped to
the window, in ms per single run.  None without a trace, without single
runs, or where the program records no such span."""

from harness.spans import span_ms


def read(rec):
    runs = [r for r in rec.done if r["entry"] == "run"]
    ms = span_ms(rec, "io.write")
    return None if ms is None or not runs else ms / len(runs)
