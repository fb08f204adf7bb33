"""writer_native_pct: of the display-77 records the program wrote in the
traced window, the share that the native formatter (the program's
io/d77fmt.cpp, slb_format_d77_rows) wrote, in %: 100 x io.records_native
/ io.records, the program's counters (slb2d_tpu_torch.tracing), which
grow only while spans are recorded, so only in the traced window.  Below 100 where the
library failed to build or load on the measuring host and the Python
formatter wrote the lines.  None without a trace, without records, or
where the program keeps no such counter."""


def read(rec):
    if rec.trace is None:
        return None
    try:
        from slb2d_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    records = counts.get("io.records", 0)
    if records <= 0:
        return None
    return 100.0 * counts.get("io.records_native", 0) / records
