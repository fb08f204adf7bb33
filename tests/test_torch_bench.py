"""The port's bench (slb2d_tpu_torch.bench) on the CPU: every mode's bench
function at a tiny shape with device="cpu" (the runners run their plain
versions there), the metric names, and main()'s refusals.  main() itself
runs on a CUDA card only; without one it prints one JSON error line and
exits 1."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from slb2d_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a display-4 run of a few hundred steps (omega=10: T=0.63) and a 3-point
# sweep of ~140 steps (omega=50)
DRIVER = dict(N=8, M=24, t_start=0.01, omega=10.0, reps=2)
SWEEP = dict(B=3, N=4, M=24, omega=50.0, t_start=0.01)

MODES = [
    (["driver", "torch"], DRIVER),
    (["driver", "torch", "fast", "4"], DRIVER),
    (["driver", "stream", "exact", "77"], DRIVER),
    (["cuda", "24", "8"], dict(chunk=5, reps=2)),
    (["stream", "24", "8"], dict(chunk=5, reps=2)),
    (["torch", "24", "8"], dict(chunk=5, reps=2)),
    (["f64", "24", "8"], dict(chunk=5, reps=2)),
    (["sweep", "torch"], dict(SWEEP, K=5, reps=2)),
    (["sweep", "stack"], dict(SWEEP, K=20)),
    (["sweep", "stack", "omega"], dict(SWEEP, K=20)),
    (["sweep", "lanes"], SWEEP),
    (["sweep", "lanes", "omega"], SWEEP),
]


@pytest.fixture(scope="module")
def records():
    return [bench.run_mode(argv, "cpu", **depth) for argv, depth in MODES]


@pytest.mark.parametrize("i", range(len(MODES)),
                         ids=[" ".join(a) for a, _ in MODES])
def test_mode_runs_small_on_the_cpu(records, i):
    rec = records[i]
    assert set(rec) == {"metric", "value", "unit", "wall_s", "steps"}
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["wall_s"] > 0 and rec["steps"] > 0
    assert rec["unit"] == "updates/sec"
    json.dumps(rec)


def test_metric_names_are_distinct(records):
    names = [r["metric"] for r in records]
    assert len(set(names)) == len(names), names
    assert "lane-packed sweep kernel B4" in names[MODES.index(
        (["sweep", "lanes"], SWEEP))]
    assert "fast-time" in names[1] and "exact-time" in names[0]
    assert "display=77" in names[2] and "[stream tiling]" in names[2]


def test_sweep_lanes_returns_the_runner_result():
    ups, wall, steps, (sweep, (av, cap, state)) = bench.bench_sweep(
        "lanes", device="cpu", **SWEEP)
    assert steps == sweep.n_steps and av.shape == (3, 8)
    assert set(cap) == {"v_dr", "v_y", "m_x", "norm"}
    assert state[0].shape == (sweep.base.NHP, 3 * sweep.base.MP)
    assert all(av[:, 0] > 0)


def test_engines_that_need_a_card_refuse_the_cpu():
    """No mode gives way to another engine: impl=auto and impl=cuda need
    a card, and movie is not ported."""
    for argv in (["auto"], ["driver", "cuda"]):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            bench.run_mode(argv, "cpu", **DRIVER)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bench.run_mode(["movie"], "cpu")
    with pytest.raises(ValueError, match="unknown bench mode"):
        bench.run_mode(["pallas"], "cpu")


def _one_json_line(out):
    lines = out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_main_without_a_card_prints_one_error_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["sweep", "lanes"]) == 1
    cap = capsys.readouterr()
    line = _one_json_line(cap.out)
    assert line["value"] is None and line["device"] is None
    assert "no CUDA device" in line["error"]
    assert line["unit"] == "updates/sec"
    assert "Traceback" in cap.err


def test_main_on_an_exception_prints_the_traceback_first(monkeypatch,
                                                         capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "device_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for argv, what in ((["movie"], "ROADMAP"), (["bogus"], "unknown")):
        assert bench.main(argv) == 1
        cap = capsys.readouterr()
        line = _one_json_line(cap.out)
        assert line["value"] is None and what in line["error"]
        assert line["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
        assert "Traceback" in cap.err and what in cap.err


def test_main_prints_the_record_with_device_and_launches(monkeypatch,
                                                         capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "device_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    seen = []

    def fake(argv, device):
        seen.append((argv, device))
        return dict(metric="m", value=2.5e10, unit="updates/sec",
                    wall_s=0.25, steps=6384)

    monkeypatch.setattr(bench, "run_mode", fake)
    assert bench.main(["sweep", "lanes"]) == 0
    line = _one_json_line(capsys.readouterr().out)
    assert seen == [(["sweep", "lanes"], "cuda:0")]
    assert line["value"] == 2.5e10 and line["metric"] == "m"
    assert line["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert set(line["launches"]) == {"B1", "B1 resident",
                                     "B1 per-half-step", "B2", "B3",
                                     "B3 per-omega", "B4"}


def test_module_entry_point_refuses_the_cpu():
    proc = subprocess.run([sys.executable, "-m", "slb2d_tpu_torch.bench",
                           "sweep", "lanes"], capture_output=True,
                          text=True, timeout=120, cwd=ROOT,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 1, proc.stderr
    line = _one_json_line(proc.stdout)
    assert line["value"] is None and "no CUDA device" in line["error"]
