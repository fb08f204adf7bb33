"""chunk_submit_ms: the host time spent handing chunks to the engine in
the traced window (the step table's copy to the card and the kernel
launches, or a sweep's advance; on the tensor path the steps): the
program's engine.chunk spans (slb2d_tpu_torch.tracing, on the trace's
clock) clipped to the window, less the engine.fetch spans inside them
(a runner's copy that waits for the chunk's kernels to end), in ms per
request.  None without a trace, or where the program records no such
span."""

from harness.spans import span_ms


def read(rec):
    ms = span_ms(rec, "engine.chunk", less=("engine.fetch",))
    return None if ms is None or not rec.done else ms / len(rec.done)
