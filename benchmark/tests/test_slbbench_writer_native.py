"""writer_native_pct on hand-made records: the share of the display-77
records that the native formatter wrote, from the program's counters;
None without a trace or without records (the program before the
counters, or a cell that writes none)."""

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


def test_the_share_of_native_records(counts):
    read = spec.reader("writer_native_pct")
    counts({"io.records": 1630, "io.records_native": 1630})
    assert read(_Rec(True)) == 100.0
    counts({"io.records": 1630, "io.records_native": 815})
    assert read(_Rec(True)) == pytest.approx(50.0)
    counts({"io.records": 1630})
    assert read(_Rec(True)) == 0.0


@pytest.mark.parametrize("traced,d", [
    (False, {"io.records": 1630, "io.records_native": 1630}),
    (True, {"launches.B1.resident": 3}),
    (True, {"io.records": 0, "io.records_native": 0}),
])
def test_nothing_without_a_trace_or_records(counts, traced, d):
    counts(d)
    assert spec.reader("writer_native_pct")(_Rec(traced)) is None


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "slb2d_tpu_torch.tracing", None)
    assert spec.reader("writer_native_pct")(_Rec(True)) is None


def test_the_program_counts_what_its_writer_wrote():
    """A traced stretch of the program's display-77 writer reads 100 with
    the native formatter and 0 with the Python one."""
    import io

    import numpy as np

    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.io import native, writers
    from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
    model = SuperlatticeModel(SimConfig(
        display=77, E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
        n_harmonics=4, phi_y_min=-10.0, phi_y_max=10.0, B=0.1, t_start=1.0,
        g_grid=16, dt=1e-3))
    recs = np.ones((5, 13), np.float32)
    tracing.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "format_d77_rows", lambda *a, **kw: None)
        with tracing.recording():
            writers.write_display77_from_record(io.StringIO(), model,
                                                recs, quiet=True)
    assert spec.reader("writer_native_pct")(_Rec(True)) == 0.0
    tracing.reset()
