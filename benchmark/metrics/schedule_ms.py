"""schedule_ms: the host time the single runs' step schedule took in the
traced window (runtime/schedule.iter_chunks making each chunk's tables):
the program's schedule.chunk spans (slb2d_tpu_torch.tracing, on the
trace's clock) clipped to the window, in ms per single run.  None without
a trace, without single runs, or where the program records no such
span."""

from harness.spans import span_ms


def read(rec):
    runs = [r for r in rec.done if r["entry"] == "run"]
    ms = span_ms(rec, "schedule.chunk")
    return None if ms is None or not runs else ms / len(runs)
