"""Distribution-function reconstruction for frame outputs (host part).

f(phi_x, phi_y) = sum_n a_n cos(n phi_x) + b_n sin(n phi_x), evaluated on
the reference's phi_x grid (float accumulation from -PI by 0.01,
src/boltzmann_c_solver.c:341), as a host float64 matrix product.  A copy
of ``slb2d_tpu/ops/frames.py`` without its device reconstruction
(``reconstruct_on_device``, ROADMAP.md queue A item 5);
tests/test_torch_host_parity.py holds it to the original bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..constants import PI

f64 = np.float64


def phi_x_grid(dtype=np.float32) -> np.ndarray:
    """The reference's float-accumulated phi_x samples:
    `for(ffloat phi_x = -PI; phi_x < PI; phi_x += 0.01)` (:341)."""
    vals = []
    x = dtype(-PI)
    while float(x) < PI:
        vals.append(x)
        x = dtype(f64(x) + 0.01)
    return np.asarray(vals, dtype)


class FrameReconstructor:
    """Precomputed cos/sin tables + the reconstruction product.

    Tables replicate the C argument computation cos((double)(n_f32 *
    phi_x_f32)) and are kept in float64; the contraction runs in float64 on
    the host and the result is rounded to the model dtype before the
    clamp, matching the C `ffloat value` accumulation to within a few
    ulps.
    """

    def __init__(self, model):
        self.model = model
        D = model.np_dtype
        self.phi_x = phi_x_grid(D)
        n = np.arange(model.NHP, dtype=D)
        prod = (n[:, None] * self.phi_x[None, :]).astype(D)  # float product
        self.cos_t = np.cos(prod.astype(f64)).T.copy()       # (X, NHP)
        self.sin_t = np.sin(prod.astype(f64)).T.copy()

    def reconstruct(self, a: np.ndarray, b: np.ndarray,
                    m_lo: int, m_hi: int, clamp=True) -> np.ndarray:
        """f over (phi_x, m) for m in [m_lo, m_hi); clamped at 0 (:348)."""
        D = self.model.np_dtype
        asl = a[:, m_lo:m_hi].astype(f64)
        bsl = b[:, m_lo:m_hi].astype(f64)
        F = (self.cos_t @ asl + self.sin_t @ bsl).astype(D)
        if clamp:
            F = np.maximum(F, 0)
        return F

    def reconstruct_equilibrium(self, m_lo: int, m_hi: int) -> np.ndarray:
        a0 = self.model.a0[:, m_lo:m_hi].astype(f64)
        F0 = (self.cos_t @ a0).astype(self.model.np_dtype)
        return np.maximum(F0, 0)
