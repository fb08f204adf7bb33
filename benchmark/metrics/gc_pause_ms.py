"""gc_pause_ms: the time CPython's garbage collector held the process in
the window, all generations, in ms per single run.  The collector runs
when the program's (and torch's) allocations call for it, and a full pass
walks every object the process holds: a stall on whichever run is in
flight, at the edge of run_p95_s."""


def read(rec):
    runs = [r for r in rec.done if r["entry"] == "run"]
    if not runs:
        return None
    paused = sum(e - s for _, s, e in rec.collections)
    return 1e3 * paused / len(runs)
