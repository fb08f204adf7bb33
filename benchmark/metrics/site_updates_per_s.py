"""site_updates_per_s: 2 (N+1) (M+1) steps points, summed over every
request the window completed, over the window's wall (the first request's
start to the last one's end)."""


def read(rec):
    done = rec.done
    if not done or rec.window_s <= 0:
        return None
    return sum(r["sites"] for r in done) / rec.window_s
