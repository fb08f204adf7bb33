"""Each traffic mix through the program's plain tensor engine on the CPU,
at a tiny grid, against the plain reference: the clean run is correct;
the runs with the timed path broken underneath are not; and the control,
the reference in the precision below the configuration's, is not."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from harness import check, window
import run as runmod

CELLS = ("hires.d4", "hires.d77", "map.paper", "map.edc64")
SEED = 2**31 + 4242


def _run(name, seconds=0.5):
    cell, extra = tiny_cell(name)
    rec = window.measure(cell, SEED, seconds, extra=extra,
                         log=lambda msg: None)
    checks = check.compare(rec, SEED, "cpu")
    return cell, rec, runmod.result(cell, rec, False, {}, checks)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_agrees_with_the_reference(name):
    cell, rec, out = _run(name)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"]["gap"]["value"] < 1e-4
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(out)[-1] == "checks"


def _unchanged_step(c, state, trig, do_av, **kw):
    """A step that returns its state unchanged (but for the clock)."""
    return state.replace(t=state.t + c.dt, step=state.step + 1)


def _half_batch(real):
    """A step that advances only the first half of a batch of points."""
    def step(c, state, trig, do_av, **kw):
        new = real(c, state, trig, do_av, **kw)
        if state.a.dim() < 3 or state.a.shape[0] < 2:
            return new
        h = state.a.shape[0] // 2
        keep = lambda x, y: torch.cat([x[:h], y[h:]]) if (
            torch.is_tensor(x) and x.dim() and x.shape[0] == state.a.shape[0]
        ) else x
        return type(new)(**{f: keep(getattr(new, f), getattr(state, f))
                            for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a",
                                      "hs_edge_b", "av", "t", "step")})
    return step


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_caught(name,
                                                          monkeypatch):
    from slb2d_tpu_torch.ops import stencil
    monkeypatch.setattr(stencil, "full_step", _unchanged_step)
    _, _, out = _run(name, seconds=0.1)
    assert not out["correct"]


@pytest.mark.parametrize("name", ("map.paper", "map.edc64"))
def test_half_of_the_batch_left_out_is_caught(name, monkeypatch):
    from slb2d_tpu_torch.ops import stencil
    monkeypatch.setattr(stencil, "full_step", _half_batch(stencil.full_step))
    _, _, out = _run(name, seconds=0.1)
    assert not out["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(name,
                                                          monkeypatch):
    from slb2d_tpu_torch.io import writers
    from slb2d_tpu_torch.ops import observables
    from slb2d_tpu_torch.parallel import sweep
    real_obs = observables.scaled_observables
    real_fin = sweep.ParameterSweep._finalize
    real_rec = writers.write_display77_from_record

    def obs(*a, **kw):
        out = real_obs(*a, **kw)
        out["av"][4] = out["av"][4] * np.float32(1.05)     # A(omega)
        return out

    def fin(self, *a, **kw):
        out = real_fin(self, *a, **kw)
        out["A"] = (out["A"] * np.float32(1.05)).astype(out["A"].dtype)
        return out
    def rec77(out, model, rec, **kw):
        rec = np.array(rec, copy=True)
        rec[1] = rec[1] * 1.05                              # v_dr
        return real_rec(out, model, rec, **kw)
    monkeypatch.setattr(observables, "scaled_observables", obs)
    monkeypatch.setattr(sweep.ParameterSweep, "_finalize", fin)
    monkeypatch.setattr(writers, "write_display77_from_record", rec77)
    _, _, out = _run(name, seconds=0.1)
    assert not out["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limit(name):
    """The reference in bfloat16 in the program's place."""
    cell, rec, out = _run(name, seconds=0.1)
    low = check.compare(rec, SEED, "cpu", program=lambda req, pts:
                        check.reference_rows(req, pts, "cpu",
                                             torch.bfloat16))
    assert low["gap"] > cell.limits["gap"]["limit"]


def test_a_failed_request_makes_the_run_incorrect(monkeypatch):
    from harness import drive
    real = drive.run_request

    def flaky(req, spans):
        if req.index == 1:
            raise RuntimeError("planted")
        return real(req, spans)
    monkeypatch.setattr(drive, "run_request", flaky)
    _, rec, out = _run("hires.d4")
    assert out["attempted"] >= 2
    assert out["failed"] == 1 and not out["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_calibration_readings_separate(name):
    """calibrate.py's readings at the tiny size: the program under the
    cell's limit, the control far above it."""
    import calibrate
    cell, extra = tiny_cell(name)
    r = calibrate.readings(cell, SEED, "cpu", control=True, extra=extra)
    assert r["failed"] == 0
    assert r["gap"] < cell.limits["gap"]["limit"] < r["control_gap"]
