"""model_build_ms: the host time SuperlatticeModel's constructor took in
the traced window (a0, the Bessel coefficients, the masks and scalars; a
sweep builds one model a point): the program's model.build spans
(slb2d_tpu_torch.tracing, on the trace's clock) clipped to the window, in
ms per request.  None without a trace, or where the program records no
such span."""

from harness.spans import span_ms


def read(rec):
    ms = span_ms(rec, "model.build")
    return None if ms is None or not rec.done else ms / len(rec.done)
