"""slb2d_tpu_torch.tracing: the spans and counters inside the program.

Tiny runs on the CPU (impl=torch, device=cpu): the span tree of a
single run and of a sweep, their run ids, the stamps against the
profiler's own ranges, the IO thread's spans, the parameter server's
mutation, the chunk counter and the writers' spans, bench.py's movie
timing from spans, and nothing recorded or called while nothing
records.  The one test marked `cuda` holds the stamps to the
profiler's ranges on a card.  This file imports neither jax nor the JAX
package, so it also runs where they are absent:

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""

import contextlib
import io
import statistics
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu_torch import tracing
from slb2d_tpu_torch.bench import movie_timing
from slb2d_tpu_torch.config import SimConfig, parse_cmd
from slb2d_tpu_torch.parallel.mesh import make_mesh
from slb2d_tpu_torch.parallel.sweep import ParameterSweep
from slb2d_tpu_torch.runtime.loop import Simulation

CPU = torch.device("cpu")
ARGV = ["display=4", "E_dc=1.0", "E_omega=2.0", "omega=40.0", "mu=1",
        "alpha=0.9495", "n-harmonics=6", "PhiYmin=-10", "PhiYmax=10",
        "B=0.1", "t-max=0.05", "g-grid=24", "dt=1e-3", "impl=torch",
        "device=cpu", "quiet=1"]
TINY = dict(E_dc=1.0, E_omega=2.0, omega=40.0, mu=1.0, alpha=0.9495,
            n_harmonics=6, phi_y_min=-10.0, phi_y_max=10.0, B=0.1,
            g_grid=24, dt=1e-3, impl="torch", quiet=True)

# a single run's spans: name -> the name of its parent (None: outermost)
RUN_TREE = {"config.parse": None, "sim.init": None, "model.build":
            "sim.init", "sim.plan": "sim.init", "sim.consts": "sim.init",
            "sim.bootstrap": "sim.init", "sim.run": None,
            "schedule.chunk": "sim.run",
            "engine.chunk": "sim.run", "engine.fetch": "sim.run",
            "io.write": "sim.run"}
# the profiler's range and the recorder's stamps of one span: the median
# of their gaps (us).  One clock gives gaps of a few us; a single pair can
# lie further apart where the host is preempted between the two stamps or
# the profiler grows its buffers, so no one gap is held to a bound.
STAMP_MEDIAN_US = 10


@pytest.fixture(autouse=True)
def fresh():
    """Every test starts with no span or counter."""
    tracing.reset()
    yield
    tracing.reset()


def _d4_run():
    cfg = parse_cmd(ARGV)
    sim = Simulation(cfg, out=io.StringIO())
    sim.run()
    return sim


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    """fn() under torch.profiler: (its result, the spans, the profiler's
    ranges by name as [(start_ns, end_ns)]).  One throwaway range first
    takes the profiler's first-range set-up."""
    with profile(activities=list(activities)) as prof:
        with torch.profiler.record_function("warm"):
            pass
        out = fn()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out, tracing.spans(), ranges


def _stamp_gaps_us(spans, ranges):
    """|recorder stamp - profiler stamp| of every span's start and end, in
    us, pairing each name's spans and ranges in order of start."""
    gaps = []
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        theirs = sorted(ranges.get(name, []))
        assert len(mine) == len(theirs), (name, len(mine), len(theirs))
        for (a0, a1), (b0, b1) in zip(mine, theirs):
            gaps += [abs(a0 - b0) / 1e3, abs(a1 - b1) / 1e3]
    return gaps


@pytest.fixture(scope="module")
def profiled_d4():
    """One tiny display-4 run under torch.profiler: (sim, spans,
    ranges)."""
    tracing.reset()
    sim, spans, ranges = _profiled(_d4_run)
    tracing.reset()
    return sim, spans, ranges


def test_off_records_nothing_and_calls_no_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened while untraced")
    monkeypatch.setattr(tracing, "_Range", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _d4_run()
    assert tracing.spans() == []
    assert tracing.span("a") is tracing.span("b", run=3)


def test_off_span_allocates_nothing():
    def spans(n):
        for _ in range(n):
            with tracing.span("engine.chunk"):
                pass
    spans(100)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spans(10000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, tracing.__file__)]
    grew = [d for d in after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "lineno") if d.size_diff > 0]
    assert grew == []


def test_profiled_run_gives_the_span_tree(profiled_d4):
    sim, spans, _ = profiled_d4
    names = {s.name for s in spans}
    assert names == set(RUN_TREE)
    by_id = {s.id: s for s in spans}
    for s in spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        assert parent == RUN_TREE[s.name], s
    assert {s.run for s in spans if s.name != "config.parse"} == {
        sim.run_id}
    assert [s.run for s in spans if s.name == "config.parse"] == [None]
    assert all(s.thread == threading.get_ident() for s in spans)


def test_profiled_run_stamps_match_the_profiler(profiled_d4):
    _, spans, ranges = profiled_d4
    assert statistics.median(_stamp_gaps_us(spans, ranges)) <= (
        STAMP_MEDIAN_US)


class _Kept(io.StringIO):
    """An output stream that keeps its text when the run closes it."""

    def close(self):
        pass


@pytest.mark.parametrize("display, lines", [(77, 2 * 17), (4, 3),
                                            (3, 629 * 23 + 1)])
def test_runs_count_their_chunk_and_write_once(display, lines):
    """Display 77 (a header and a line a record), display 4 (two headers
    and the line) and display 3 (629 phi_x rows by 23 phi_y and a norm):
    one chunk, and one io.write span under sim.run for all of its
    lines."""
    out = _Kept()
    with contextlib.redirect_stdout(io.StringIO()), tracing.recording():
        Simulation(SimConfig(display=display, t_start=0.02, **TINY),
                   out=out, device=CPU).run()
    assert out.getvalue().count("\n") == lines
    assert tracing.counters()["engine.chunks"] == 1
    spans = tracing.spans()
    by_id = {s.id: s for s in spans}
    writes = [s for s in spans if s.name == "io.write"]
    assert len(writes) == 1
    assert by_id[writes[0].parent].name == "sim.run"


def test_frame_batches_are_fetched_and_formatted_once_a_batch(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()), tracing.recording():
        Simulation(SimConfig(display=7, t_start=0.03, frame_batch=2,
                             out_file="out.txt", **TINY), device=CPU).run()
    frames = sorted(tmp_path.glob("frame*.data"))
    assert len(frames) >= 3
    names = [s.name for s in tracing.spans()]
    batches = -(-len(frames) // 2)
    assert names.count("io.fetch") == names.count("io.format") == batches


def test_movie_timing_counts_each_stretch_once():
    """bench.py's movie mode: a fetch inside a chunk is the chunk's, a
    fetch after the schedule's end is the round's, and the wait inside a
    frame's build is the wait's alone."""
    def s(name, start_ms, end_ms, ident, parent=None):
        return tracing.Span(name, int(start_ms * 1e6), int(end_ms * 1e6),
                            ident, parent, 1, 1)
    got = movie_timing([
        s("schedule.chunk", 0, 1, 1),
        s("engine.chunk", 1, 5, 2),
        s("engine.fetch", 3, 5, 3, parent=2),   # the chunk's own wait
        s("engine.fetch", 5, 6, 4),             # a chunk's records
        s("io.write", 6, 8, 5),
        s("schedule.chunk", 8, 9, 6),
        s("frames.build", 9, 13, 7),
        s("io.wait", 10, 12, 8, parent=7),
        s("engine.fetch", 13, 20, 9),           # the round's last fetch
        s("io.fetch", 9, 11, 10), s("io.format", 11, 15, 11)])
    assert got == pytest.approx(dict(chunks=7e-3, frames=2e-3, wait=2e-3,
                                     fetch=2e-3, format=4e-3))


def test_sweep_gives_its_spans():
    cfg = SimConfig(display=4, t_start=0.02, **TINY)
    with tracing.recording():
        sweep = ParameterSweep(cfg, {"E_dc": np.linspace(0.5, 2.0, 3)},
                               device=CPU)
        sweep.run()
    spans = tracing.spans()
    by_id = {s.id: s for s in spans}

    def ancestors(s):
        while s.parent is not None:
            s = by_id[s.parent]
            yield s.name
    models = [s for s in spans if s.name == "model.build"]
    assert len(models) == sweep.B == 3
    assert all("sweep.init" in ancestors(s) for s in models)
    names = [s.name for s in spans]
    for name in ("sweep.points", "sweep.consts", "sweep.states",
                 "engine.chunk", "sweep.finalize", "engine.fetch",
                 "sweep.run"):
        assert name in names, name
    assert [p for s in spans if s.name == "sweep.finalize"
            for p in ancestors(s)] == ["sweep.run"]
    assert {s.run for s in spans} == {sweep.run_id}


def test_sweep_blocks_join_the_sweeps_run():
    cfg = SimConfig(display=4, t_start=0.02, **TINY)
    with tracing.recording():
        sweep = ParameterSweep(cfg, {"E_dc": np.linspace(0.5, 2.0, 4)},
                               mesh=make_mesh((2,), ("sweep",),
                                              devices=[CPU] * 2))
        sweep.run()
    spans = tracing.spans()
    assert sum(s.name == "sweep.init" for s in spans) == 3
    assert sum(s.name == "model.build" for s in spans) == 4 + 4
    assert {s.run for s in spans} == {sweep.run_id}


def test_frames_are_fetched_and_formatted_off_the_main_thread(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()), tracing.recording():
        sim = Simulation(SimConfig(display=7, t_start=0.03, frame_batch=2,
                                   out_file="out.txt", **TINY), device=CPU)
        sim.run()
    spans = tracing.spans()
    main = threading.get_ident()
    io_spans = [s for s in spans if s.name in ("io.fetch", "io.format")]
    assert {s.name for s in io_spans} == {"io.fetch", "io.format"}
    assert all(s.thread != main and s.run == sim.run_id
               for s in io_spans)
    assert all(s.thread == main for s in spans if s not in io_spans)
    assert "frames.build" in {s.name for s in spans}


def test_parameter_server_round_gives_a_mutation_span():
    cfg = SimConfig(display=4, t_start=0.02, read_from="stdin", **TINY)
    with tracing.recording():
        sim = Simulation(cfg, out=io.StringIO(), device=CPU)
        sim.run(repl_stream=io.StringIO("E_dc 1.5 0.02\nexit\n"))
    spans = tracing.spans()
    muts = [s for s in spans if s.name == "sim.mutation"]
    assert len(muts) == 1 and muts[0].run == sim.run_id
    inside = [s.name for s in spans if s.parent == muts[0].id]
    assert "model.build" in inside and "sim.consts" in inside
    assert sum(s.name == "io.write" for s in spans) == 2


def test_counters_add_by_name_and_prefix():
    tracing.count("launches.B3.shared.cluster")
    tracing.count("launches.B3.omega.cluster", 2)
    tracing.count("launches.B3.omega.streaming", 3)
    tracing.count("launches.B30", 7)
    assert tracing.counted("launches.B3") == 6
    assert tracing.counted("launches.B3.omega") == 5
    assert tracing.counted("launches.B3.omega.cluster") == 2
    assert tracing.counted("launches.B4") == 0
    tracing.reset()
    assert tracing.counters() == {}


def test_spanned_times_every_next():
    with tracing.recording():
        assert list(tracing.spanned("schedule.chunk", range(3))) == [0, 1,
                                                                     2]
    assert [s.name for s in tracing.spans()] == ["schedule.chunk"] * 4


def test_recording_nests_and_ends():
    with tracing.recording():
        with tracing.recording():
            pass
        with tracing.span("outer", run=5), tracing.span("inner"):
            assert tracing.run_id() == 5
    with tracing.span("after"):
        pass
    inner, outer = tracing.spans()
    assert (inner.name, inner.parent, inner.run) == ("inner", outer.id, 5)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_active_while_recording_or_profiling():
    """active() is what a runner asks before reading a tally that only a
    traced run reports: off by default, on inside recording() and while
    torch.profiler records."""
    assert not tracing.active()
    with tracing.recording():
        assert tracing.active()
    assert not tracing.active()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.active()
    assert not tracing.active()


@pytest.mark.cuda
def test_card_stamps_match_the_profiler():
    """A display-4 run on B1 under the profiler with CUDA activity: the
    recorder's stamps agree with the profiler's ranges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    argv = [a for a in ARGV if not a.startswith(("impl", "device"))]

    def run():
        sim = Simulation(parse_cmd(argv + ["impl=cuda"]), out=io.StringIO())
        sim.run()
        torch.cuda.synchronize()
        return sim
    run()                                  # the kernel library's build
    tracing.reset()
    sim, spans, ranges = _profiled(run, (ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA))
    assert sim.engine_tag().startswith("cuda-b1")
    assert "engine.build" in {s.name for s in spans}
    gaps = _stamp_gaps_us(spans, ranges)
    print(f"stamp gaps on {torch.cuda.get_device_name(0)} over "
          f"{len(spans)} spans: median {statistics.median(gaps):.2f} us, "
          f"largest {max(gaps):.2f} us")
    assert statistics.median(gaps) <= STAMP_MEDIAN_US
