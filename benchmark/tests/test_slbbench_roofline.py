"""The frozen operation and byte counts, and the least times they give at
the data sheet's peaks."""

import pytest

from harness import roofline


def per_step_us(N, M, points=1, chains=False):
    ops = roofline.flops(N, M, 1, points, chains=chains)
    return ops / roofline.F32_FLOPS_PEAK * 1e6


def test_peaks_are_the_data_sheets():
    assert roofline.F32_FLOPS_PEAK == 67e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def test_b1_on_the_tall_grid_is_1_338_us_a_step():
    # N=400 M=4000: chip_smoke.py's 2.676 us at half the peak
    assert per_step_us(400, 4000) == pytest.approx(1.338, abs=5e-4)


def test_b1_at_baseline_4_is_0_335_us_a_step():
    assert per_step_us(100, 4000) == pytest.approx(0.3349, abs=5e-4)


def test_b3_bounds_at_the_sweep_grid():
    # the 64-point E_dc sweep and the 16x16 paper map, a step
    assert per_step_us(40, 500, 64) == pytest.approx(1.078, abs=5e-3)
    assert per_step_us(40, 500, 256, chains=True) == pytest.approx(
        4.30, abs=5e-3)


def test_operations_bound_the_runs_not_bytes():
    ops = roofline.flops(100, 4000, 16281, 1, av_steps=6283)
    nb = roofline.nbytes(100, 4000, 16281)
    t, by = roofline.least_seconds(ops, nb)
    assert by == "operations"
    assert t == pytest.approx(ops / 67e12)
    # one av step: three weighted sums over M columns and the chain
    assert roofline.flops(2, 10, 0, av_steps=1) == 6 * 10 + 22
