"""model_grid_shared_pct on hand-made records: the share of a sweep's
point models that took a grid part an earlier point built, from the
program's counters; None without a trace or without a sweep (the program
before the counters, or a cell of single runs); and the program's own
counts over a small drive sweep and a small mu sweep."""

import numpy as np
import pytest

from harness import spec
from harness.trace import Trace

from slb2d_tpu_torch import tracing


class _Rec:
    def __init__(self, traced):
        self.trace = Trace([], [], [], (0.0, 1.0)) if traced else None


@pytest.fixture
def counts(monkeypatch):
    def put(d):
        monkeypatch.setattr(tracing, "counters", lambda: dict(d))
    return put


def test_the_share_of_shared_grids(counts):
    read = spec.reader("model_grid_shared_pct")
    counts({"model.points": 256, "model.grids_shared": 255})
    assert read(_Rec(True)) == pytest.approx(100.0 * 255 / 256)
    counts({"model.points": 64, "model.grids_shared": 0})
    assert read(_Rec(True)) == 0.0
    counts({"model.points": 6})
    assert read(_Rec(True)) == 0.0


@pytest.mark.parametrize("traced,d", [
    (False, {"model.points": 256, "model.grids_shared": 255}),
    (True, {"launches.B3.omega.cluster": 1}),
    (True, {"model.points": 0, "model.grids_shared": 0}),
])
def test_nothing_without_a_trace_or_a_sweep(counts, traced, d):
    counts(d)
    assert spec.reader("model_grid_shared_pct")(_Rec(traced)) is None


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "slb2d_tpu_torch.tracing", None)
    assert spec.reader("model_grid_shared_pct")(_Rec(True)) is None


@pytest.mark.parametrize("params,want", [
    ({"E_dc": np.linspace(0.5, 2.0, 4)}, 100.0 * 3 / 4),
    ({"mu": np.array([0.5, 1.0, 1.0, 2.0])}, 100.0 * 1 / 4),
])
def test_the_program_counts_its_sweeps_grids(params, want):
    """A traced sweep's construction: one grid part a distinct mu."""
    import torch

    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.parallel.sweep import ParameterSweep
    cfg = SimConfig(display=4, E_dc=1.0, E_omega=2.0, omega=40.0, mu=1.0,
                    alpha=0.9495, n_harmonics=4, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=0.02, g_grid=16,
                    dt=1e-3, impl="torch", quiet=True)
    tracing.reset()
    with tracing.recording():
        ParameterSweep(cfg, params, device=torch.device("cpu"))
    got = spec.reader("model_grid_shared_pct")(_Rec(True))
    tracing.reset()
    assert got == pytest.approx(want)
