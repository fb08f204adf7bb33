"""The entries of the program that a window drives, and the harness's
spans around them.

  run     a single run, the path the slb2d CLI takes (cli.main):
          config.parse_cmd on the request's key=value line, then
          runtime.loop.Simulation(cfg, out=<a sink>) and .run(); the
          display-4 line is read back from the text the sink holds
  sweep   a parameter sweep, the path the absorption map takes:
          a SimConfig (parse_cmd on the key=value line), then
          parallel.sweep.ParameterSweep(cfg, {swept axes}, device=) and
          .run(), which gives each point's observables

Each request records the spans "build" (the config and the driver's
constructor) and "run" (.run()), on the host clock and, under the
profiler, as ranges named "slbbench:<span>" in the trace.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from reference.solver import D4_COLUMNS, D77_COLUMNS

SPAN_PREFIX = "slbbench:"

# ParameterSweep.run()'s keys for the display-4 columns
_SWEEP_KEYS = dict(v_dr_inst="v_dr_inst", A="A", norm="norm",
                   v_y_inst="v_y_inst", m_inst="m_over_m_x_inst",
                   v_dr_av="v_dr_av", v_y_av="v_y_av",
                   m_av="m_over_m_x_av", Asin="Asin")


class Sink:
    """The output stream of a run: keeps what is written and ignores
    close(), so that no run writes its table to disk."""

    def __init__(self):
        self.parts = []

    def write(self, s):
        self.parts.append(s)
        return len(s)

    def flush(self):
        pass

    def close(self):
        pass

    def text(self):
        return "".join(self.parts)


def table_rows(text, display):
    """[{column: value}] of the data lines in `text`: the display-4 line,
    or every display-77 line in order."""
    cols = D77_COLUMNS if display == 77 else D4_COLUMNS
    rows = []
    for ln in text.splitlines():
        if not ln.strip() or ln.startswith("#"):
            continue
        vals = [float(x) for x in ln.split()]
        if len(vals) != len(cols):
            raise ValueError(f"a display-{display} line has {len(cols)} "
                             f"columns, this one {len(vals)}")
        rows.append(dict(zip(cols, vals)))
    if not rows:
        raise ValueError(f"the run wrote no display-{display} line")
    return rows


class Spans:
    """The harness's spans: (name, start, end) on the host clock; under
    the profiler each is also a named range in the trace."""

    def __init__(self, profiled=False):
        self.items = []
        self.profiled = profiled

    @contextlib.contextmanager
    def open(self, name):
        rf = contextlib.nullcontext()
        if self.profiled:
            from torch.profiler import record_function
            rf = record_function(SPAN_PREFIX + name)
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.items.append((name, t0, time.perf_counter()))


def run_request(req, spans):
    """One request through its entry; returns a function that gives its
    rows (one dict of display-4 columns a point, or a display-77 run's
    lines), so that the text is read after the window."""
    from slb2d_tpu_torch import config as cfgmod
    if req.entry == "run":
        from slb2d_tpu_torch.runtime.loop import Simulation
        sink = Sink()
        with spans.open("build"):
            cfg = cfgmod.parse_cmd(req.argv())
            sim = Simulation(cfg, out=sink)
        with spans.open("run"):
            sim.run()
        text, display = sink.text(), cfg.display
        return lambda: table_rows(text, display)
    if req.entry == "sweep":
        from slb2d_tpu_torch.parallel.sweep import ParameterSweep
        with spans.open("build"):
            cfg = cfgmod.parse_cmd(req.argv())
            sweep = ParameterSweep(cfg, req.params)
        with spans.open("run"):
            res = sweep.run()
        mu = float(cfg.mu)

        def rows():
            out = []
            for i, p in enumerate(req.points):
                row = dict(p, mu=mu)
                row.update({col: float(np.asarray(res[key])[i])
                            for col, key in _SWEEP_KEYS.items()})
                out.append(row)
            return out
        return rows
    raise ValueError(f"unknown entry {req.entry!r}")
