"""sweep_build_ms: the mean of the harness's span around parse_cmd and
ParameterSweep(...) (the per-point models and the batched constants), over
the sweeps of the window."""


def read(rec):
    v = [r["build_s"] for r in rec.done
         if r["entry"] == "sweep" and r["build_s"] is not None]
    return 1e3 * sum(v) / len(v) if v else None
