"""The tall.d4 cell (config tall_n400_m4000: N=400 M=4000, f32, whole on
one card, B1's resident form at its fullest plan): it loads with its
readers, its requests keep its grid and length for every seed, its warm
request keeps the grid, and b1_exposed_pct reads the program's
resident-form cycle tally (None without a trace or without the counters:
the program before the tally)."""

import pytest

from harness import spec, traffic
from harness.trace import Trace

from slb2d_tpu_torch import tracing

CELL = "tall.d4"
SEEDS = (0, 7, 3600000031, 2**31 + 4242, 2**33 + 5)


def test_the_cell_loads_with_its_readers():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["args"]["g-grid"] == 4000
    assert cell.config["args"]["n-harmonics"] == 400
    assert cell.config["args"]["dtype"] == "f32"
    assert cell.config["reduced"] == []
    hires = spec.load_cell("hires.d4")
    assert cell.traffic == hires.traffic
    assert {k: v for k, v in cell.config["args"].items()
            if k != "n-harmonics"} == {
        k: v for k, v in hires.config["args"].items() if k != "n-harmonics"}
    assert {m["name"] for m in cell.end_to_end} == {"site_updates_per_s",
                                                   "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"kernel_roofline_pct", "launches_per_kstep", "device_idle_pct",
            "b1_exposed_pct"} <= names
    assert "b2_sync_wait_pct" not in names
    assert "b1_exposed_pct" in {m["name"] for m in hires.per_layer}
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
        assert (s["g-grid"], s["n-harmonics"], s["display"]) == (4000, 400,
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
        4000, 400)
    assert warm.settings["dtype"] == "f32"
    assert 500 <= warm.steps <= 1_500 < first.steps
    assert all(warm.settings[k] == first.settings[k]
               for k in cell.traffic["draw"])


class _Rec:
    def __init__(self, traced):
        self.trace = Trace([], [], [], (0.0, 1.0)) if traced else None


@pytest.fixture
def counts(monkeypatch):
    def put(d):
        monkeypatch.setattr(tracing, "counters", lambda: dict(d))
    return put


def test_the_share_of_exposed_cycles(counts):
    read = spec.reader("b1_exposed_pct")
    counts({"b1.band_cycles": 8_000_000, "b1.exposed_cycles": 2_000_000,
            "b1.waits": 128, "b1.waits_open": 64,
            "launches.B1.resident": 3})
    assert read(_Rec(True)) == pytest.approx(25.0)
    counts({"b1.band_cycles": 400})
    assert read(_Rec(True)) == 0.0


@pytest.mark.parametrize("traced,d", [
    (False, {"b1.band_cycles": 100, "b1.exposed_cycles": 10}),
    (True, {"launches.B1.resident": 3}),
    (True, {"b1.waits": 128, "b1.waits_open": 64}),
    (True, {"b1.band_cycles": 0, "b1.exposed_cycles": 0}),
    (True, {"b2.band_cycles": 100, "b2.sync_cycles": 10}),
])
def test_nothing_without_a_trace_or_the_counters(counts, traced, d):
    counts(d)
    assert spec.reader("b1_exposed_pct")(_Rec(traced)) is None


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "slb2d_tpu_torch.tracing", None)
    assert spec.reader("b1_exposed_pct")(_Rec(True)) is None
