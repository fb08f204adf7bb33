"""run_build_ms: the mean of the harness's span around parse_cmd and
Simulation(...) (the driver's constructor: the model, the schedule's
constants, the bootstrap), over the single runs of the window."""


def read(rec):
    v = [r["build_s"] for r in rec.done
         if r["entry"] == "run" and r["build_s"] is not None]
    return 1e3 * sum(v) / len(v) if v else None
