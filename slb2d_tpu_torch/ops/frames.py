"""Distribution-function reconstruction for frame outputs.

f(phi_x, phi_y) = sum_n a_n cos(n phi_x) + b_n sin(n phi_x), evaluated on
the reference's phi_x grid (float accumulation from -PI by 0.01,
src/boltzmann_c_solver.c:341): a host float64 matrix product, or for
states on a card two matrix products on the device in the state's dtype
(``reconstruct_on_device``, the counterpart of the JAX package's).  The
host part is a copy of ``slb2d_tpu/ops/frames.py``;
tests/test_torch_host_parity.py holds it to the original bit for bit.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

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
        self._dev = None     # (device, dtype, cos_t, sin_t, w_norm) tensors

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

    def reconstruct_on_device(self, a, b, m_lo: int, m_hi: int):
        """(F, norm_sum) from tensors a, b on their own device, in their
        dtype: F the clamped (X, m_hi - m_lo) frame from two matrix
        products, norm_sum the 0-d a[0] @ w_norm (the caller applies the
        2*pi*sqrt(alpha) scaling).  Both are fresh tensors, enqueued behind
        whatever last wrote a and b, so a kernel that later updates the
        state in place cannot change them.  Float32 products run at full
        precision (TF32 off, float32 matmul precision "highest"), the
        counterpart of the JAX package's Precision.HIGHEST: TF32 would
        cost the frame values and the printed norm ~3 digits.  The
        caller's settings are restored after the call.  Float64 states
        take float64 tables and products (the JAX package, on a TPU
        without them, reconstructs those on the host).  On CPU tensors
        this is also the plain version the tests hold the CUDA run to."""
        dev, dt = a.device, a.dtype
        if self._dev is None or self._dev[:2] != (dev, dt):
            def table(x):
                return torch.as_tensor(np.asarray(x), device=dev).to(dt)
            self._dev = (dev, dt, table(self.cos_t), table(self.sin_t),
                         table(self.model.w_norm))
        _, _, cos_t, sin_t, w_norm = self._dev
        with full_f32_matmul():
            F = (torch.matmul(cos_t, a[:, m_lo:m_hi])
                 + torch.matmul(sin_t, b[:, m_lo:m_hi]))
            norm_sum = torch.matmul(a[0], w_norm)
        return torch.clamp_min(F, 0), norm_sum

    def reconstruct_equilibrium(self, m_lo: int, m_hi: int) -> np.ndarray:
        a0 = self.model.a0[:, m_lo:m_hi].astype(f64)
        F0 = (self.cos_t @ a0).astype(self.model.np_dtype)
        return np.maximum(F0, 0)


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products at full precision inside the block (TF32
    off for cuBLAS, float32 matmul precision "highest"); the settings in
    force before are restored on the way out."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        prec = torch.get_float32_matmul_precision()
    except RuntimeError:     # the caller mixed the legacy and new APIs
        prec = None
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        if prec is not None:
            torch.set_float32_matmul_precision(prec)
        if torch.backends.cuda.matmul.allow_tf32 != tf32:
            torch.backends.cuda.matmul.allow_tf32 = tf32
