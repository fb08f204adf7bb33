"""model_grid_shared_pct: of the point models the program's sweeps made
in the traced window, the share that took a grid part (a0 and its ghost
copy, the masks, the weights, the Bessel multipliers) an earlier point of
the same sweep built, in %: 100 x model.grids_shared / model.points, the
program's counters (slb2d_tpu_torch.tracing), which grow only while spans
are recorded, so only in the traced window.  A sweep over the drive
alone builds one grid part, so it reads 100 x (B - 1) / B; one over mu
or alpha one a distinct value.  None without a trace, without a sweep,
or where the program keeps no such counter."""


def read(rec):
    if rec.trace is None:
        return None
    try:
        from slb2d_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    points = counts.get("model.points", 0)
    if points <= 0:
        return None
    return 100.0 * counts.get("model.grids_shared", 0) / points
