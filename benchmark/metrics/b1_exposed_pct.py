"""b1_exposed_pct: of the cycles B1's resident form spends in its step
loop in the traced window, summed over its bands, the share in the part
of each step in which a band computes no interior cell (phase B's edge
columns and the arrival, the wait and the halo read with their block
barriers), in %: 100 x b1.exposed_cycles / b1.band_cycles, the program's
counters (slb2d_tpu_torch.tracing), which grow only while spans are
recorded, so only in the traced window.  None without a trace, or where
the program keeps no such counter (a resident form without the cycle
tally, or a window in which the resident form did not run)."""


def read(rec):
    if rec.trace is None:
        return None
    try:
        from slb2d_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    cycles = counts.get("b1.band_cycles", 0)
    if cycles <= 0:
        return None
    return 100.0 * counts.get("b1.exposed_cycles", 0) / cycles
