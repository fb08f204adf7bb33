"""device_idle_pct: the share of the traced window with no device
activity; busy time is the union of the intervals of every kernel, memory
copy and memory set in the window, whatever their names."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
