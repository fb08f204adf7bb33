"""The one generator of requests: a traffic mix's parameters and a
configuration, drawn from a seed.

A traffic mix (traffic/<name>.json) holds:

  entry   "run": one single run a request, through the path the slb2d
          CLI takes; "sweep": one parameter sweep a request, through the
          path the absorption map takes
  args    key=value settings of every request (the CLI's keys)
  grid    (sweeps) the swept axes, each {"linspace": [lo, hi, n]}; the
          points are their product, the first axis slowest
  draw    {key: [lo, hi]}: each request draws these uniformly from the
          seed, in the order listed (a sweep draws one value a request,
          shared by its points)
  warm    key=value settings that cut the warm-up request to about a
          thousand steps at the cell's own shapes
  check   how many requests (and points of each) the check of `correct`
          compares with the reference

A configuration (configs/<name>.json) gives its settings under "args".
The request's settings are the configuration's, then the mix's, then the
draws; the same seed gives the same requests in the same order, and every
seed gives requests of the same sizes (only the drive values differ).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from reference.solver import loop_times

# the keys of a point that the reference takes
POINT_KEYS = ("E_dc", "E_omega", "omega", "B")


@dataclasses.dataclass
class Request:
    index: int
    entry: str                 # "run" or "sweep"
    settings: dict             # key=value settings (CLI keys)
    params: dict               # sweeps: {key: array of the points' values}
    points: list               # each point's E_dc, E_omega, omega, B
    steps: int                 # loop steps (a sweep: its longest point's)
    av_steps: int              # averaging steps summed over the points
    captures: int              # loop-exit captures and display-77 lines
    chains: bool               # each point its own drive period

    def argv(self):
        return [f"{k}={_fmt(v)}" for k, v in self.settings.items()]

    @property
    def n_points(self):
        return len(self.points)


def _fmt(v):
    return repr(float(v)) if isinstance(v, float) else str(v)


def _axis(spec):
    lo, hi, n = spec["linspace"]
    return np.linspace(float(lo), float(hi), int(n))


def grid_points(grid: dict):
    """{key: flat array} of the product of the swept axes (ij order)."""
    if not grid:
        return {}
    axes = np.meshgrid(*[_axis(v) for v in grid.values()], indexing="ij")
    return {k: a.ravel() for k, a in zip(grid, axes)}


def _dtype(settings):
    return np.float64 if settings.get("dtype") == "f64" else np.float32


@functools.lru_cache(maxsize=4096)
def _steps(t_start, omega, dt, D, display, driven):
    """(loop steps, averaging steps, display-77 lines) of one point: a
    display-77 run averages at its lines only, one each time frame_time
    (dt a step, back to 0 after a line) reaches 0.01; the others average
    at every step with t >= t_start; nothing averages without a drive."""
    t, n_steps, _ = loop_times(t_start, omega, dt, D)
    if not driven:
        return n_steps, 0, 0
    if display != 77:
        return n_steps, int(np.count_nonzero(t[:n_steps] >= D(t_start))), 0
    lines, ft, dt = 0, D(0), D(dt)
    for _ in range(n_steps):
        if ft >= D(0.01):
            lines += 1
            ft = D(0)
        ft = D(ft + dt)
    return n_steps, lines, lines


def make_request(index, config, traffic, settings_extra, draws):
    """The request of the mix with these draws (a dict of key: value)."""
    settings = dict(config["args"])
    settings.update(traffic.get("args", {}))
    settings.update(draws)
    settings.update(settings_extra)
    params = {k: v.copy() for k, v in
              grid_points(traffic.get("grid", {})).items()}
    n = len(next(iter(params.values()))) if params else 1
    points = [{k: float(params[k][i]) if k in params else float(settings[k])
               for k in POINT_KEYS} for i in range(n)]
    D = _dtype(settings)
    t_start, dt = float(settings["t-max"]), float(settings["dt"])
    display = int(settings["display"])
    steps, av_steps, lines = 0, 0, 0
    for p in points:
        n_steps, n_av, n_lines = _steps(t_start, p["omega"], dt, D, display,
                                        bool(D(p["E_omega"]) > 0))
        steps = max(steps, n_steps)
        av_steps += n_av
        lines += n_lines
    chains = traffic["entry"] == "sweep" and "omega" in params
    return Request(index=index, entry=traffic["entry"], settings=settings,
                   params=params, points=points, steps=steps,
                   av_steps=av_steps,
                   captures=lines + (len(points) if chains else 0),
                   chains=chains)


def requests(config, traffic, seed, settings_extra=None):
    """The cell's requests in order, without end, drawn from `seed`."""
    rng = np.random.default_rng(int(seed))
    extra = dict(settings_extra or {})
    index = 0
    while True:
        draws = {k: float(rng.uniform(lo, hi))
                 for k, (lo, hi) in traffic.get("draw", {}).items()}
        yield make_request(index, config, traffic, extra, draws)
        index += 1


def warm_request(config, traffic, seed, settings_extra=None):
    """The warm-up request: the first request's draws with the mix's
    `warm` settings, which keep its shapes and cut its steps."""
    first = next(requests(config, traffic, seed, settings_extra))
    draws = {k: first.settings[k] for k in traffic.get("draw", {})}
    extra = dict(traffic.get("warm", {}))
    extra.update(settings_extra or {})
    return make_request(-1, config, traffic, extra, draws)
