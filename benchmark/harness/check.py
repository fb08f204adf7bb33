"""Whether what the window produced is correct: a sample of its answers
against the plain reference (reference/solver.py).

Once the window has closed, requests are drawn from the seed among those
the window completed (and, of a sweep, points, the one with the most
steps always among them).  The reference works each sampled point out
again from its parameters, at the configuration's precision, and the
number compared is

    gap = max over the nine observables and the sampled points of
          |program - reference| / max(|reference|, FLOOR)

the relative gap of each observable, measured absolutely below FLOOR.
Each cell's limit is in limits/<cell>.json, with the readings it was set
from.
"""

from __future__ import annotations

import numpy as np

from reference.solver import (D77_OBSERVABLES, OBSERVABLES, Grid,
                              run_points, run_series)

# observables below this size are compared absolutely (a sum that cancels,
# such as v_y, is far smaller than the terms it sums)
FLOOR = 1e-2


def grid_of(req):
    s = req.settings
    return Grid(N=int(s["n-harmonics"]), M=int(s["g-grid"]),
                mu=float(s["mu"]), alpha=float(s["alpha"]),
                phi_y_min=float(s["PhiYmin"]),
                phi_y_max=float(s["PhiYmax"]), dt=float(s["dt"]),
                t_start=float(s["t-max"]))


def state_dtype(req):
    import torch
    return torch.float64 if req.settings.get("dtype") == "f64" \
        else torch.float32


def sample(rec, seed):
    """[(request index, [point indices])] to compare, drawn from seed."""
    chk = rec.cell.traffic.get("check", {})
    rng = np.random.default_rng([int(seed), 1])
    done = [r["index"] for r in rec.done]
    if not done:
        return []
    picks = rng.choice(len(done), size=min(int(chk.get("requests", 1)),
                                           len(done)), replace=False)
    out = []
    for i in sorted(int(p) for p in picks):
        req = rec.reqs[done[i]]
        k = int(chk.get("points", 1))
        if req.n_points <= k:
            pts = list(range(req.n_points))
        else:
            # the point with the longest drive period runs the most steps
            longest = int(np.argmin([p["omega"] for p in req.points]))
            rest = [j for j in range(req.n_points) if j != longest]
            pts = sorted([longest] + [int(j) for j in rng.choice(
                rest, size=k - 1, replace=False)])
        out.append((done[i], pts))
    return out


def series(req):
    """Whether the request is a display-77 run (its answers are lines)."""
    return req.entry == "run" and int(req.settings["display"]) == 77


def gap(program_rows, reference_rows, columns=OBSERVABLES):
    """The number compared: max relative gap, absolute below FLOOR."""
    worst = 0.0
    for p, r in zip(program_rows, reference_rows):
        for col in columns:
            pv, rv = float(p[col]), float(r[col])
            d = abs(pv - rv) / max(abs(rv), FLOOR)
            if not np.isfinite(d):
                return float("inf")
            worst = max(worst, d)
    return worst


def reference_rows(req, pts, device, dtype=None):
    """The reference's rows of a request's points `pts`; of a display-77
    run, all its lines."""
    dtype = dtype or state_dtype(req)
    if series(req):
        return run_series(grid_of(req), req.points[0], device=device,
                          dtype=dtype)
    return run_points(grid_of(req), [req.points[j] for j in pts],
                      device=device, dtype=dtype)


def compare(rec, seed, device, program=None):
    """{"gap": value} of the sampled answers against the reference, and
    of display-77 runs also {"lines": the difference in their number of
    lines} (exact).  program(req, pts) -> rows stands in for the window's
    own answers (the control)."""
    worst, lines = 0.0, None
    for idx, pts in sample(rec, seed):
        req = rec.reqs[idx]
        ref = reference_rows(req, pts, device)
        if series(req):
            got = (program(req, pts) if program is not None
                   else rec.rows(idx))
            lines = max(lines or 0, abs(len(got) - len(ref)))
            worst = max(worst, gap(got, ref, D77_OBSERVABLES))
            continue
        got = (program(req, pts) if program is not None
               else [rec.rows(idx)[j] for j in pts])
        worst = max(worst, gap(got, ref))
    return {"gap": worst} if lines is None else {"gap": worst,
                                                 "lines": lines}
