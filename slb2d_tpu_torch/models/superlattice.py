"""The superlattice Boltzmann model: grids, equilibrium, derived constants.

Physics per arXiv:1401.6047: the electron distribution f(phi_x, phi_y, t) is
expanded as a truncated Fourier series in the periodic momentum coordinate
phi_x; the solver state is two real arrays a[n, m], b[n, m] over harmonics
n in [0, N] and a uniform phi_y grid of M cells (reference:
src/boltzmann_c_solver.c:100-122).

TPU layout: arrays are (NHP, MP) with the harmonic axis padded to a sublane
multiple and the phi_y axis padded to a lane multiple of 128, so stencil
rolls and row reductions stay tile-aligned.  The reference's CUDA row
padding to 128 bytes (src/boltzmann_solver.c:102) is the same idea one
level down.

Reference quirks preserved exactly (so float32 runs pin against the C
solver, src/boltzmann_c_solver.c):
  * every derived scalar is computed through float32 exactly where the
    C code stores into `ffloat` (= float, src/boltzmann.h:15);
  * harmonic row N is never updated by the stencil (the n-loop runs
    n < N, :366) — it is a permanent zero ghost in the dynamics;
  * ghost rows m=0 and m=M+2 are Dirichlet zeros (:104-106).
"""

from __future__ import annotations

import numpy as np

from .. import tracing
from ..config import SimConfig
from ..constants import PI
from .bessel import bessel_In


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


class SuperlatticeModel:
    """Precomputed grids, masks and scalars for one parameter set.

    All mutable physics parameters (E_dc, E_omega, omega, mu, alpha, B) are
    snapshot here; the interactive parameter server rebuilds the model (the
    state arrays survive, matching reference src/boltzmann_c_solver.c:270-281).
    """

    @tracing.traced("model.build")
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.f64 = cfg.dtype == "f64"
        self.np_dtype = np.float64 if self.f64 else np.float32

        f = np.float64 if self.f64 else np.float32  # storage rounding
        self.N = int(cfg.n_harmonics)
        self.M = int(cfg.g_grid)

        # ---- sizes (reference: src/boltzmann_c_solver.c:102-108) ----
        self.NH = self.N + 1            # NSIZE
        self.MS = self.M + 3            # MSIZE; ghosts at m=0 and m=M+2
        self.TM = self.M + 1            # TMSIZE
        self.NHP = round_up(self.NH, 8)
        self.MP = round_up(self.MS, 128)

        # ---- parameters as the reference stores them (ffloat) ----
        self.E_dc = f(cfg.E_dc)
        self.E_omega = f(cfg.E_omega)
        self.omega = f(cfg.omega)
        self.mu = f(cfg.mu)
        self.alpha = f(cfg.alpha)
        self.B = f(cfg.B)
        self.dt = f(cfg.dt)

        # ---- derived scalars (src/boltzmann_c_solver.c:87-113) ----
        # T = 2*PI/omega in double, stored to ffloat
        self.T = f(2 * PI / float(self.omega)) if float(self.omega) > 0 else f(0)
        self.dPhi = f((f(cfg.phi_y_max) - f(cfg.phi_y_min)) / self.M)
        self.phi_y_min = f(cfg.phi_y_min)
        self.phi_y_max = f(cfg.phi_y_max)
        self.nu = f(1 + self.dt / 2)
        self.nu2 = f(self.nu * self.nu)
        self.nu_tilde = f(1 - self.dt / 2)
        self.bdt = f(self.B * self.dt / (4 * self.dPhi))

        # ---- phi_y grid over padded m axis (phi_y(m), :69) ----
        m_idx = np.arange(self.MP, dtype=self.np_dtype)
        self.phi = (self.phi_y_min + self.dPhi * (m_idx - 1)).astype(self.np_dtype)

        # ---- equilibrium a0 (Bessel x Gaussian, :116-122) ----
        mu64 = float(self.mu)
        alpha64 = float(self.alpha)
        coef = np.zeros(self.NHP, dtype=self.np_dtype)
        for n in range(self.NH):
            c = (bessel_In(n, mu64) * (0.5 if n == 0 else 1.0)
                 / (PI * bessel_In(0, mu64)) * np.sqrt(mu64 / (2 * PI * alpha64)))
            coef[n] = self.np_dtype(c)
        self.a0_coef = coef
        gauss = np.exp(-mu64 * self.phi.astype(np.float64) ** 2 / 2)
        a0 = coef[:, None].astype(np.float64) * gauss[None, :]
        self.a0 = a0.astype(self.np_dtype)
        # columns outside [0, MS) are pure padding: zero them
        self.a0[:, self.MS:] = 0

        # Ghost content of main buffer 0: the initial a <- a0 copy
        # (src/boltzmann_c_solver.c:136) fills ghost cells (m=0, m=M+2,
        # row N) that the stencil never rewrites, so they persist in
        # buffer 0 while buffer 1's stay zero.  The half-step stencil READS
        # them (a_next at m-1 for m=1; row N at n+1 for n=N-1), so the
        # dynamics alternate with step parity.  a0_ghost is a0 restricted
        # to that never-written region.
        interior = np.zeros((self.NHP, self.MP), dtype=bool)
        interior[:self.N, 1:self.M + 2] = True
        self.a0_ghost = np.where(interior, 0, self.a0).astype(self.np_dtype)

        # ---- stencil masks (branch-free n=0/1 handling; the data-driven
        # equivalent of kernel K311's peeled branches,
        # reference src/boltzmann_gpu.cu:477-577) ----
        nvec = np.arange(self.NHP)
        # n_float is zeroed at non-updated rows (n >= N): mu_t/mu_t1
        # vanish there, so the stencil outputs are zero via the nu_row
        # factors alone — the row-mask selects fold into existing
        # multiplies (the C loop never reaches n >= N, :367)
        self.n_float = np.where(nvec < self.N, nvec, 0).astype(
            self.np_dtype)[:, None]                               # (NHP,1)
        self.row_update = (nvec < self.N)[:, None]                # n in [0,N)
        self.n_ge2 = np.where(nvec >= 2, 1, 0).astype(self.np_dtype)[:, None]
        w = np.ones(self.NHP)
        w[0] = 0.0
        if self.NHP > 1:
            w[1] = 2.0
        self.w_n = w.astype(self.np_dtype)[:, None]               # (n==1?2:1)*(n==0?0:1)
        self.b_row_mask = (nvec > 0)[:, None]                     # b_0 == 0 always

        cols = np.arange(self.MP)
        # step_on_grid writes m=1..M+1 (m <= TMSIZE, :361);
        # step_on_half_grid writes m=1..M (m < TMSIZE, :391)
        self.col_main = ((cols >= 1) & (cols <= self.M + 1))[None, :]
        self.col_half = ((cols >= 1) & (cols <= self.M))[None, :]

        # ---- observable weight vectors (zero outside each loop's bounds) ----
        dPhi = self.np_dtype(self.dPhi)
        in_av = (cols >= 1) & (cols < self.TM)        # av(): m=1..M (:417)
        in_d4 = (cols >= 1) & (cols < self.M)         # display-4 inst: m=1..M-1 (:241)
        self.w_av = np.where(in_av, dPhi, 0).astype(self.np_dtype)
        self.w_av_phi = (self.w_av * self.phi).astype(self.np_dtype)
        # eval_norm's bounds m=1..M (:291) coincide with av()'s — alias
        self.w_norm = self.w_av
        self.w_d4 = np.where(in_d4, dPhi, 0).astype(self.np_dtype)
        self.w_d4_phi = (self.w_d4 * self.phi).astype(self.np_dtype)

        # ---- observable multipliers (double -> ffloat; :247-249) ----
        i0 = bessel_In(0, mu64)
        i1 = bessel_In(1, mu64)
        self.v_dr_multiplier = self.np_dtype(2 * i0 * PI * np.sqrt(alpha64) / i1)
        self.v_y_multiplier = self.np_dtype(4 * PI * i0 / i1)
        self.m_over_multiplier = self.np_dtype(PI * alpha64 * np.sqrt(alpha64))

    # -- convenience -------------------------------------------------------

    def zeros_state_arrays(self):
        z = np.zeros((self.NHP, self.MP), dtype=self.np_dtype)
        return z

    def initial_a(self) -> np.ndarray:
        """a starts at the equilibrium a0 (reference :136)."""
        return self.a0.copy()

    def scalar_params(self) -> dict:
        """The traced scalars consumed by the stepper (jit-stable shapes)."""
        return dict(
            E_dc=self.E_dc, E_omega=self.E_omega, omega=self.omega, B=self.B,
            dt=self.dt, nu=self.nu, nu2=self.nu2, nu_tilde=self.nu_tilde,
            bdt=self.bdt,
        )
