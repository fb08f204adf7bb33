"""The trace's arithmetic on hand-made events: the union of device
intervals, the idle gaps by span, the readers, and the p95."""

import statistics

import pytest

from harness import spec, trace
from harness.trace import Trace


def test_union_of_overlapping_and_nested_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25), (30, 31)]
    assert trace.union_seconds(iv) == pytest.approx(26e-6)
    assert trace.union_seconds([]) == 0.0


def test_idle_gaps_inside_the_window():
    busy = [(10, 20), (15, 30), (50, 60)]
    assert trace.idle_gaps(busy, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    assert trace.idle_gaps([(0, 100)], 0, 100) == []


def _hand_trace():
    kernels = [("k_a", 0.0, 400.0), ("k_b", 500.0, 600.0),
               ("k_a", 900.0, 1200.0)]     # the last one runs past the end
    copies = [("Memcpy HtoD", 350.0, 450.0)]
    spans = [("build", 0.0, 450.0), ("run", 450.0, 1000.0)]
    return Trace(kernels, copies, spans, (0.0, 1000.0))


def test_breakdown_names_ops_and_idle_spans():
    b = trace.breakdown(_hand_trace())
    ops = dict(b["device_ops"])
    assert ops["k_a"] == pytest.approx(500e-6)     # 400 + 100 clipped
    assert ops["k_b"] == pytest.approx(100e-6)
    assert ops["Memcpy HtoD"] == pytest.approx(100e-6)
    gaps = dict(b["idle_gaps"])
    # idle: 450-500 and 600-900, both inside "run"
    assert gaps == {"idle in run": pytest.approx(350e-6)}


class _Rec:
    def __init__(self, tr, requests):
        self.trace, self.requests = tr, requests
        self.window_s = 1e-3
        self.collections = []

    @property
    def done(self):
        return [r for r in self.requests if not r["failed"]]


def test_readers_on_a_hand_made_window():
    reqs = [dict(entry="run", steps=2000, flops=67e12 * 40e-6, bytes=0.0,
                 sites=10, failed=False, start=0.0, end=1e-3,
                 build_s=2e-4)]
    rec = _Rec(_hand_trace(), reqs)
    idle = spec.reader("device_idle_pct")(rec)
    assert idle == pytest.approx(35.0)              # 350 of 1000 us
    launches = spec.reader("launches_per_kstep")(rec)
    assert launches == pytest.approx(3 / 2.0)
    roof = spec.reader("kernel_roofline_pct")(rec)  # 40 of 600 us
    assert roof == pytest.approx(100 * 40 / 600)
    assert spec.reader("run_build_ms")(rec) == pytest.approx(0.2)
    assert spec.reader("sweep_build_ms")(rec) is None
    assert spec.reader("site_updates_per_s")(rec) == pytest.approx(1e4)
    assert spec.reader("gc_pause_ms")(rec) == pytest.approx(0.0)
    rec.collections = [(0, 0.0, 1e-4), (2, 5e-4, 8e-4)]
    assert spec.reader("gc_pause_ms")(rec) == pytest.approx(0.4)


def test_readers_without_a_trace_return_nothing():
    rec = _Rec(None, [])
    for name in ("device_idle_pct", "launches_per_kstep",
                 "kernel_roofline_pct"):
        assert spec.reader(name)(rec) is None


def test_p95_of_the_runs():
    p95 = spec.reader("run_p95_s")
    walls = [0.2] * 190 + [0.3] * 10
    reqs = [dict(entry="run", start=0.0, end=w, failed=False)
            for w in walls]
    rec = _Rec(None, reqs)
    assert p95(rec) == pytest.approx(
        statistics.quantiles(walls, n=100, method="inclusive")[94])
    assert 0.2 <= p95(rec) <= 0.3
    walls = list(range(1, 201))
    rec.requests = [dict(entry="run", start=0.0, end=float(w),
                         failed=False) for w in walls]
    # inclusive: 1 + 0.95 (n - 1)
    assert p95(rec) == pytest.approx(190.05)


class _Event:
    def __init__(self, name, cuda, start_us, dur_us):
        self._n, self._cuda = name, cuda
        self._s, self._d = int(start_us * 1e3), int(dur_us * 1e3)

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


class _Prof:
    """What from_profiler reads of a finished torch.profiler.profile."""
    def __init__(self, events):
        kineto = type("K", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def test_from_profiler_sorts_hand_made_events():
    ev = [_Event("slbbench:build", False, 0.0, 450.0),
          _Event("slbbench:run", False, 450.0, 550.0),
          _Event("slbbench:run", True, 450.0, 550.0),   # GPU annotation
          _Event("aten::add", False, 460.0, 5.0),
          _Event("k_a", True, 0.0, 400.0),
          _Event("Memcpy HtoD (Pageable -> Device)", True, 350.0, 100.0),
          _Event("Memset (Device)", True, 700.0, 1.0)]
    tr = trace.from_profiler(_Prof(ev))
    assert tr.kernels == [("k_a", 0.0, 400.0)]
    assert [n for n, _, _ in tr.copies] == [
        "Memcpy HtoD (Pageable -> Device)", "Memset (Device)"]
    assert tr.spans == [("build", 0.0, 450.0), ("run", 450.0, 1000.0)]
    assert tr.window == (0.0, 1000.0)
    assert tr.busy_s == pytest.approx(451e-6)


def test_from_profiler_reads_this_torchs_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("slbbench:run"):
            torch.ones(64).add_(1.0)
    tr = trace.from_profiler(prof)
    assert [n for n, _, _ in tr.spans] == ["run"]
    assert tr.window_s > 0
    assert tr.kernels == [] and tr.copies == []
