"""The least time the card could take for the work a window completed.

The operation and byte counts are counted from the algorithm and the
shapes of the problem, whatever kernel implements it: they are a frozen
copy of the counts in the repository's chip_smoke.py (main_path_flops,
bound_ms), kept here so that a change to the program cannot change the
yardstick.  Only two things differ from that script:

  * the peak: NVIDIA's data sheet gives an H100 SXM 67e12 float32
    FLOP/s outside the tensor cores, with a fused multiply-add counted as
    two operations.  chip_smoke.py divides by half of it, the rate of
    separate multiplies and adds, which is a property of its build
    (-fmad=false) and not of the card;
  * the bytes are those of the problem, (N+1) x (M+3) cells a grid, not
    of the program's padded layout.

Operations, per live cell of a half-step (rows 0..N-1, columns 1..M+1 of
the main grid and 1..M of the half grid): mu_t and mu_t1 from their
column's coefficients 2, one a and one b difference 2, g 7, h 6, xi 2,
1/xi 1, a 4, b 4.  Per column of a half-step the coefficients of cos_t
and cos_t_dt, 2 each; per point and step E_dc + E_omega cos for the four
cos values, 2 each.  Per averaging step of a point three weighted sums
over columns 1..M (a multiply and an add a column each) and the av chain
(22).  Per point with its own drive period (omega swept) four angle
additions a step (12) and four weighted sums over the columns at its
loop exit.  Bytes: the state (a, b, a_hs, b_hs) read once and written
once, a0 and its ghost copy read once, and ten schedule values a step.
"""

from __future__ import annotations

F32_FLOPS_PEAK = 67e12          # H100 SXM data sheet, FMA = 2 operations
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet

CELL_FLOPS = 28
COLUMN_FLOPS = 4
STEP_FLOPS = 8
AV_COLUMN_FLOPS = 6
AV_STEP_FLOPS = 22
CAPTURE_COLUMN_FLOPS = 8
CHAIN_FLOPS = 12


def flops(N, M, steps, points=1, av_steps=0, captures=0, chains=False):
    """Floating-point operations of `steps` steps of `points` points on an
    N x M grid, `av_steps` averaging steps summed over the points,
    `captures` loop-exit captures, and the per-point trig chains when
    `chains` (omega swept)."""
    cols = 2 * M + 1                    # main grid M+1, half grid M
    per_step = CELL_FLOPS * N * cols + COLUMN_FLOPS * cols + STEP_FLOPS
    if chains:
        per_step += CHAIN_FLOPS
    return (per_step * steps * points
            + (AV_COLUMN_FLOPS * M + AV_STEP_FLOPS) * av_steps
            + CAPTURE_COLUMN_FLOPS * M * captures)


def nbytes(N, M, steps, points=1, itemsize=4, a0_arrays=2):
    """Bytes: each point's state read once and written once, a0 and its
    ghost copy read once, ten schedule values a step."""
    cells = (N + 1) * (M + 3)
    return itemsize * (2 * 4 * cells * points + a0_arrays * cells
                       + steps * 10)


def least_seconds(ops, nbytes_):
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    at the data sheet's FLOP rate and the bytes at its bandwidth."""
    t_ops, t_bytes = ops / F32_FLOPS_PEAK, nbytes_ / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
