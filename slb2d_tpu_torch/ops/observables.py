"""Host-side observable finalization, float32-faithful to the reference.

The on-device running reductions live in ops/stencil.av_update; this module
computes the derived quantities emitted at output points:
norm (eval_norm, src/boltzmann_c_solver.c:289-296), the instantaneous
velocities and effective mass, and the display-4 normalization of av_data
(:236-268).  All arithmetic goes through the same float32 round-off points
as the C code so golden comparisons stay tight.
"""

from __future__ import annotations

import numpy as np

from ..constants import PI

f64 = np.float64


def _seq_sum(terms, D):
    """Strict sequential `acc = D(acc + t)` accumulation — the C loops'
    exact rounding chain (np.add.accumulate is sequential, unlike np.sum's
    pairwise reduction).  On the cancellation-prone v_y sum a different
    order shifts the result by ~5e-6 abs, 20x the reference's own
    FMA-rebuild noise (docs/DEVIATIONS.md D7) — order fidelity matters."""
    if len(terms) == 0:
        return D(0)
    return np.add.accumulate(terms.astype(D), dtype=D)[-1]


def eval_norm(model, a: np.ndarray):
    """norm = 2*pi*sqrt(alpha) * sum_{m=1..M} a0_row * dPhi  (:289-296),
    with the C loop's sequential float accumulation and per-term
    fl(a*dPhi) rounding.  Accepts the full (NHP, MP) array or just its
    harmonic-0 row."""
    D = model.np_dtype
    row = np.asarray(a[0] if a.ndim == 2 else a)
    dPhi = D(model.dPhi)
    s = _seq_sum(row[1:model.M + 1].astype(D) * dPhi, D)
    # C: norm *= 2*PI*sqrt(alpha)  — double expression, float store
    return D(f64(s) * (2 * PI * np.sqrt(f64(model.alpha))))


def instantaneous(model, a: np.ndarray, b: np.ndarray, *, bounds="d4"):
    """(v_dr, v_y, m/m_x) raw sums.  bounds: 'd4' = m<M (display-4 inline,
    :241) or 'av' = m<M+1 (av() and the sane display-77 bounds, :417).

    Exact C semantics per term and per add: v_dr/m_x terms are fl(x*dPhi),
    v_y terms fl(fl(a*phi)*dPhi) (:242-243), accumulated strictly
    sequentially at dtype."""
    D = model.np_dtype
    hi = model.M if bounds == "d4" else model.M + 1
    sl = slice(1, hi)
    dPhi = D(model.dPhi)
    phi = np.asarray(model.phi[sl], D)
    b1 = np.asarray(b[1])[sl].astype(D)
    a0 = np.asarray(a[0])[sl].astype(D)
    a1 = np.asarray(a[1])[sl].astype(D)
    v_dr = _seq_sum(b1 * dPhi, D)
    v_y = _seq_sum((a0 * phi).astype(D) * dPhi, D)
    m_x = _seq_sum(a1 * dPhi, D)
    return v_dr, v_y, m_x


def scaled_observables(model, a, b, av_data, *, bounds="d4",
                       quadrature_denom=None):
    """Apply the Bessel-ratio multipliers (:247-259).

    quadrature_denom: T for display 4 (:258), t for display 77
    (src/boltzmann_solver.c:437).  av_data is not mutated (the C path's
    in-place compounding at :319-325 is a defect we do not replicate).
    """
    D = model.np_dtype
    v_dr, v_y, m_x = instantaneous(model, a, b, bounds=bounds)
    vm, ym, mm = (model.v_dr_multiplier, model.v_y_multiplier,
                  model.m_over_multiplier)
    d = np.asarray(av_data, D).copy()
    d[1] = D(d[1] * vm)
    d[2] = D(d[2] * ym)
    d[3] = D(d[3] * mm)
    q = D(quadrature_denom if quadrature_denom is not None else model.T)
    d[4] = D(D(d[4] * vm) / q)
    d[5] = D(D(d[5] * vm) / q)
    return dict(
        v_dr_inst=D(v_dr * vm),
        v_y_inst=D(v_y * ym),
        m_over_m_x_inst=D(m_x * mm),
        av=d,
    )
