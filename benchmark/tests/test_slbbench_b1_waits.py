"""b1_wait_open_pct on hand-made records: the share of B1's resident-form
waits that found the grid barrier open, from the program's counters; None
without a trace or without the counters (the program before the split
barrier)."""

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


def test_the_share_of_open_waits(counts):
    counts({"b1.waits": 2048, "b1.waits_open": 1920, "launches.B1.resident": 1})
    assert spec.reader("b1_wait_open_pct")(_Rec(True)) == pytest.approx(93.75)
    counts({"b1.waits": 128})
    assert spec.reader("b1_wait_open_pct")(_Rec(True)) == 0.0


@pytest.mark.parametrize("traced,d", [
    (False, {"b1.waits": 128, "b1.waits_open": 128}),
    (True, {"launches.B1.resident": 3}),
    (True, {"b1.waits": 0, "b1.waits_open": 0}),
])
def test_nothing_without_a_trace_or_the_counters(counts, traced, d):
    counts(d)
    assert spec.reader("b1_wait_open_pct")(_Rec(traced)) is None


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "slb2d_tpu_torch.tracing", None)
    assert spec.reader("b1_wait_open_pct")(_Rec(True)) is None
