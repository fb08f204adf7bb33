"""kernel_roofline_pct: the least time the card could take for the work
the traced window completed (the larger of its operations at the data
sheet's 67e12 FLOP/s and its bytes at 3.35e12 B/s, counted from the
algorithm in harness/roofline.py) over the device time of every kernel in
the window, whatever its name."""

from harness import roofline


def read(rec):
    t = rec.trace
    if t is None:
        return None
    kernel_s = sum(e - s for _, s, e in t.clipped(t.kernels)) * 1e-6
    done = rec.done
    if kernel_s <= 0 or not done:
        return None
    least, _ = roofline.least_seconds(sum(r["flops"] for r in done),
                                      sum(r["bytes"] for r in done))
    return 100.0 * least / kernel_s
