"""The readers of the program's spans on hand-made records and spans:
model_build_ms, schedule_ms, chunk_submit_ms, writer_ms (through
harness/spans.py) and idle_untraced_ms.  Spans are slb2d_tpu_torch.tracing's records (ns on the
trace's clock); the trace is in us."""

import pytest

from harness import spec
from harness.trace import Trace

from slb2d_tpu_torch import tracing
from slb2d_tpu_torch.tracing import Span

SUMS = ("model_build_ms", "schedule_ms", "chunk_submit_ms", "writer_ms")
ALL = SUMS + ("idle_untraced_ms",)
MAIN, IO = 1, 2           # two threads' idents


def span(name, start_us, end_us, parent=None, thread=MAIN, ident=0):
    return Span(name, int(start_us * 1e3), int(end_us * 1e3), ident,
                parent, 1, thread)


class _Rec:
    def __init__(self, tr, entries):
        self.trace = tr
        self.requests = [dict(entry=e, failed=False) for e in entries]

    @property
    def done(self):
        return [r for r in self.requests if not r["failed"]]


def _trace(kernels, window=(1000.0, 2000.0)):
    return Trace([("k", s, e) for s, e in kernels], [], [], window)


@pytest.fixture
def spans(monkeypatch):
    """Set the spans the readers find: spans(list)."""
    def put(items):
        monkeypatch.setattr(tracing, "spans", lambda: list(items))
    return put


def test_sums_clip_to_the_window_per_request(spans):
    spans([span("model.build", 900, 1100),       # 100 us inside
           span("model.build", 1500, 1600),
           span("schedule.chunk", 1200, 1260),
           span("engine.chunk", 1300, 1340),
           span("io.write", 1950, 2100),         # 50 us inside
           span("model.build", 2500, 2600)])     # after the window
    rec = _Rec(_trace([]), ["run", "run"])
    got = {m: spec.reader(m)(rec) for m in SUMS}
    assert got == pytest.approx(dict(model_build_ms=0.1, schedule_ms=0.03,
                                     chunk_submit_ms=0.02, writer_ms=0.025))


def test_per_run_metrics_count_single_runs_only(spans):
    spans([span("model.build", 1000, 1400), span("engine.chunk", 1400, 1500),
           span("schedule.chunk", 1500, 1560)])
    rec = _Rec(_trace([]), ["sweep", "sweep", "run", "sweep"])
    assert spec.reader("model_build_ms")(rec) == pytest.approx(0.1)
    assert spec.reader("chunk_submit_ms")(rec) == pytest.approx(0.025)
    assert spec.reader("schedule_ms")(rec) == pytest.approx(0.06)
    sweeps = _Rec(_trace([]), ["sweep"])
    assert spec.reader("schedule_ms")(sweeps) is None
    assert spec.reader("writer_ms")(sweeps) is None


def test_nothing_without_a_trace_or_the_span(spans):
    spans([span("model.build", 1000, 1100)])
    for name in ALL:
        assert spec.reader(name)(_Rec(None, ["run"])) is None
    rec = _Rec(_trace([]), ["run"])
    for name in ("schedule_ms", "chunk_submit_ms", "writer_ms"):
        assert spec.reader(name)(rec) is None
    spans([])
    assert spec.reader("idle_untraced_ms")(rec) is None
    assert spec.reader("model_build_ms")(rec) is None


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    import sys
    import slb2d_tpu_torch
    monkeypatch.delattr(slb2d_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "slb2d_tpu_torch.tracing", None)
    rec = _Rec(_trace([]), ["run"])
    for name in ALL:
        assert spec.reader(name)(rec) is None


def test_chunk_submit_leaves_out_the_wait_inside_a_chunk(spans):
    spans([span("engine.chunk", 1100, 1500, ident=1),
           span("engine.fetch", 1200, 1450, parent=1, ident=2),
           span("engine.fetch", 1500, 1600, ident=3),   # after the chunk
           span("engine.chunk", 1900, 2100, ident=4),
           span("engine.fetch", 1950, 2050, parent=4, ident=5)])
    rec = _Rec(_trace([]), ["run", "run"])
    # (400 - 250) + (100 - 50) us inside the window, over two runs
    assert spec.reader("chunk_submit_ms")(rec) == pytest.approx(0.1)


def test_untraced_idle_with_nested_spans(spans):
    # idle: 1000-1100, 1300-1500, 1800-2000 (kernels 1100-1300, 1500-1800)
    kernels = [(1100, 1300), (1500, 1800)]
    spans([span("sim.init", 990, 1250, ident=1),
           span("model.build", 1020, 1080, parent=1, ident=2),
           span("sim.consts", 1030, 1060, parent=2, ident=3),
           span("sim.run", 1250, 1990, ident=4),
           span("schedule.chunk", 1300, 1350, parent=4, ident=5),
           span("engine.fetch", 1800, 1950, parent=4, ident=6)])
    rec = _Rec(_trace(kernels), ["run", "run"])
    # untraced: 1000-1020, 1080-1100, 1350-1500, 1950-2000 = 240 us
    assert spec.reader("idle_untraced_ms")(rec) == pytest.approx(0.12)


def test_untraced_idle_with_spans_on_two_threads(spans):
    # idle 1000-2000 whole; the main thread names 1100-1300 under a
    # request span, the IO thread 1200-1600 and 1900-2100
    spans([span("sim.run", 1000, 2000, ident=1),
           span("engine.chunk", 1100, 1300, parent=1, ident=2),
           span("io.fetch", 1200, 1400, thread=IO, ident=3),
           span("io.format", 1400, 1600, thread=IO, ident=4),
           span("io.format", 1900, 2100, thread=IO, ident=5)])
    rec = _Rec(_trace([]), ["run"])
    # named: 1100-1600 and 1900-2000; untraced 100 + 300 = 400 us
    assert spec.reader("idle_untraced_ms")(rec) == pytest.approx(0.4)


def test_untraced_idle_counts_the_time_between_requests(spans):
    spans([span("sim.init", 1000, 1400, ident=1),
           span("model.build", 1000, 1400, parent=1, ident=2),
           span("sim.init", 1600, 2000, ident=3),
           span("model.build", 1600, 2000, parent=3, ident=4)])
    rec = _Rec(_trace([(1700, 1800)]), ["run", "run"])
    assert spec.reader("idle_untraced_ms")(rec) == pytest.approx(0.1)
    assert spec.reader("model_build_ms")(rec) == pytest.approx(0.4)
