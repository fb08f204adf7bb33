"""The wide.d4 cell (config wide_n100_m20000: N=100 M=20000, f32, whole on
one card past its shared memory, B2's spill form): it loads with its
readers, its requests keep its grid and length for every seed, its
window runs correct on the CPU at a tiny grid through the spill form's
plain version, and b2_sync_wait_pct reads the program's spill-form tally
(None without a trace or without the counters: the program before the
tally)."""

import copy

import numpy as np
import pytest

from harness import check, spec, traffic, window
from harness.trace import Trace
import run as runmod

from slb2d_tpu_torch import tracing

CELL = "wide.d4"
SEEDS = (0, 7, 3600000031, 2**31 + 4242, 2**33 + 5)


def test_the_cell_loads_with_its_readers():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["args"]["g-grid"] == 20000
    assert cell.config["args"]["n-harmonics"] == 100
    assert cell.config["args"]["dtype"] == "f32"
    assert cell.config["reduced"] == []
    assert cell.traffic == spec.load_cell("hires.d4").traffic
    assert {m["name"] for m in cell.end_to_end} == {"site_updates_per_s",
                                                   "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"kernel_roofline_pct", "launches_per_kstep", "device_idle_pct",
            "b2_sync_wait_pct"} <= names
    assert "b1_wait_open_pct" not in names
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    lim = cell.limits["gap"]
    assert lim["lower"] < lim["limit"] < lim["upper"]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_request_is_one_point_of_16281_steps_on_the_grid(seed):
    cell = spec.load_cell(CELL)
    gen = traffic.requests(cell.config, cell.traffic, seed)
    for _ in range(4):
        req = next(gen)
        assert req.entry == "run" and req.n_points == 1
        assert req.steps == 16_281
        s = req.settings
        assert (s["g-grid"], s["n-harmonics"], s["display"]) == (20000, 100,
                                                                 4)
        assert s["impl"] == "auto" and s["dtype"] == "f32"
        for k, (lo, hi) in cell.traffic["draw"].items():
            assert lo <= s[k] <= hi


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_the_warm_request_keeps_the_grid(seed):
    cell = spec.load_cell(CELL)
    warm = traffic.warm_request(cell.config, cell.traffic, seed)
    first = next(traffic.requests(cell.config, cell.traffic, seed))
    assert (warm.settings["g-grid"], warm.settings["n-harmonics"]) == (
        20000, 100)
    assert warm.settings["dtype"] == "f32"
    assert 500 <= warm.steps <= 1_500 < first.steps
    assert all(warm.settings[k] == first.settings[k]
               for k in cell.traffic["draw"])


def test_the_window_through_the_spill_forms_plain_version(monkeypatch):
    """At N=8 M=64, t-max=0.05 at omega=40, impl=stream on the CPU with a
    forced spill plan of 2 bands (R=32): every request runs the spill
    form's plain version and the check finds it correct."""
    from slb2d_tpu_torch.ops import stepper_stream_cuda as sst
    from slb2d_tpu_torch.runtime import loop
    real = sst.spill_plan
    monkeypatch.setattr(sst, "spill_plan", lambda NHP, MP, dtype, sms=132,
                        budget=None, R=None: real(NHP, MP, dtype, sms=2,
                                                  R=32))
    tags = []
    run = loop.Simulation.run

    def spy(self, *a, **k):
        out = run(self, *a, **k)
        tags.append(self.engine_tag())
        return out
    monkeypatch.setattr(loop.Simulation, "run", spy)
    cell = copy.deepcopy(spec.load_cell(CELL))
    cell.config["args"].update({"n-harmonics": 8, "g-grid": 64})
    extra = {"t-max": 0.05, "omega": 40.0, "device": "cpu",
             "impl": "stream"}
    seed = SEEDS[3]
    rec = window.measure(cell, seed, 0.3, extra=extra, log=lambda m: None)
    out = runmod.result(cell, rec, False, {}, check.compare(rec, seed,
                                                            "cpu"))
    assert out["failed"] == 0 and out["correct"], out["checks"]
    assert out["checks"]["gap"]["value"] < 1e-4
    assert tags and set(tags) == {"stream spill"}


class _Rec:
    def __init__(self, traced):
        self.trace = Trace([], [], [], (0.0, 1.0)) if traced else None


@pytest.fixture
def counts(monkeypatch):
    def put(d):
        monkeypatch.setattr(tracing, "counters", lambda: dict(d))
    return put


def test_the_share_of_cycles_inside_the_grid_barrier(counts):
    read = spec.reader("b2_sync_wait_pct")
    counts({"b2.band_cycles": 8_000_000, "b2.sync_cycles": 1_000_000,
            "launches.B2.spill": 3})
    assert read(_Rec(True)) == pytest.approx(12.5)
    counts({"b2.band_cycles": 400})
    assert read(_Rec(True)) == 0.0


@pytest.mark.parametrize("traced,d", [
    (False, {"b2.band_cycles": 100, "b2.sync_cycles": 10}),
    (True, {"launches.B2.spill": 3}),
    (True, {"b2.band_cycles": 0, "b2.sync_cycles": 0}),
    (True, {"b1.waits": 128, "b1.waits_open": 64}),
])
def test_nothing_without_a_trace_or_the_counters(counts, traced, d):
    counts(d)
    assert spec.reader("b2_sync_wait_pct")(_Rec(traced)) is None


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "slb2d_tpu_torch.tracing", None)
    assert spec.reader("b2_sync_wait_pct")(_Rec(True)) is None
