"""run_p95_s: the 95th percentile of the wall of every single run of the
window, from parse_cmd to the display-4 line in the sink (inclusive
quantiles; at least 200 runs put ten beyond it)."""

import statistics


def p95(values):
    values = list(values)
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def read(rec):
    return p95(r["end"] - r["start"] for r in rec.done if r["entry"] == "run")
