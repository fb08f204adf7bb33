"""b2_sync_wait_pct: of the cycles B2's spill form spends in its step loop
in the traced window, summed over its bands, the share its bands spend
inside the step's grid barrier, in %: 100 x b2.sync_cycles /
b2.band_cycles, the program's counters (slb2d_tpu_torch.tracing), which
grow only while spans are recorded, so only in the traced window.  None
without a trace, or where the program keeps no such counter (a spill form
without the tally, or a window in which the spill form did not run)."""


def read(rec):
    if rec.trace is None:
        return None
    try:
        from slb2d_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    cycles = counts.get("b2.band_cycles", 0)
    if cycles <= 0:
        return None
    return 100.0 * counts.get("b2.sync_cycles", 0) / cycles
