"""launches_per_kstep: device kernels launched in the traced window, per
1,000 steps of the requests it completed (a sweep's steps counted once,
not per point)."""


def read(rec):
    t = rec.trace
    steps = sum(r["steps"] for r in rec.done)
    if t is None or steps <= 0 or not t.kernels:
        return None
    return len(t.clipped(t.kernels)) / (steps / 1000.0)
