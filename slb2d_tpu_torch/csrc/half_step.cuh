// Device code shared by the step kernels (stepper.cu, sweep_stack.cu,
// stepper_stream.cu): one stencil application at one cell, block sums,
// and the av() chain.
// The kernels compute these expressions in this one operand order, which
// is the order of their plain PyTorch version (slb2d_tpu_torch/ops/
// stencil.py: apply_half_step in the reciprocal form, av_update_from_sums).

#pragma once

#include <cuda_runtime.h>

namespace slb {

constexpr int XS_LANES = 10;

template <typename T>
struct Params {
  T E_dc, E_omega, omega, B, dt, nu, nu2, nu_tilde, bdt, t_start, t_end;
};

struct Geometry {
  int N, M, NHP, MP;
};

// One stencil application at (n, m) of one point's (NHP, MP) arrays.
// dst arrays are updated in place: the cell reads dst only at its own
// (n, m) and every neighbour from the other pair (nb).  The caller makes
// sure no thread writes nb while this runs (a kernel boundary in
// stepper.cu, a block barrier in sweep_stack.cu).
template <typename T, bool MAIN>
__device__ __forceinline__ void half_step_cell(
    T* a_dst, T* b_dst, const T* a_nb, const T* b_nb, const T* a0,
    const T* a0_ghost, const T* phi, T cos_t, T cos_t_dt,
    const Params<T>& p, const Geometry& g, T ghost_gate, T* edge_a,
    T* edge_b, int n, int m) {
  const int MP = g.MP;
  const size_t idx = (size_t)n * MP + m;

  // row masks and weights (models/superlattice.py: n_float, n_ge2, w_n,
  // row_update, b_row_mask); column masks col_main / col_half
  const T nf = n < g.N ? T(n) : T(0);
  const T n_ge2 = n >= 2 ? T(1) : T(0);
  const T w_n = n == 0 ? T(0) : (n == 1 ? T(2) : T(1));
  const T nu_a = p.nu * (n < g.N ? T(1) : T(0));
  const T nu_b = nu_a * (n > 0 ? T(1) : T(0));
  const int m_hi = MAIN ? g.M + 1 : g.M;
  const T colf = (m >= 1 && m <= m_hi) ? T(1) : T(0);

  // mu_t, mu_t1 fresh every step in the C operand order
  // (src/boltzmann_c_solver.c:363-365); never carried across steps
  const T ph = phi[m];
  const T mu_t = nf * ((p.E_dc + p.E_omega * cos_t + p.B * ph) * p.dt / T(2));
  const T mu_t1 =
      nf * ((p.E_dc + p.E_omega * cos_t_dt + p.B * ph) * p.dt / T(2));

  // neighbour indices wrap like roll; wrapped values land only where
  // n_ge2, w_n or the column masks zero them
  const int np1 = n + 1 == g.NHP ? 0 : n + 1;
  const int nm1 = n == 0 ? g.NHP - 1 : n - 1;
  const int mp1 = m + 1 == MP ? 0 : m + 1;
  const int mm1 = m == 0 ? MP - 1 : m - 1;
  const size_t rp = (size_t)np1 * MP, rm = (size_t)nm1 * MP;

  const T dmb_p = b_nb[rp + mp1] - b_nb[rp + mm1];
  const T dmb_m = b_nb[rm + mp1] - b_nb[rm + mm1];
  const T dma_p = a_nb[rp + mp1] - a_nb[rp + mm1];
  const T dma_m = a_nb[rm + mp1] - a_nb[rm + mm1];

  const T a_src = a_dst[idx];
  const T b_src = b_dst[idx];
  const T gv = p.dt * a0[idx] + a_src * p.nu_tilde - b_src * mu_t +
               p.bdt * (dmb_p - n_ge2 * dmb_m);
  const T hv = b_src * p.nu_tilde + a_src * mu_t +
               p.bdt * (w_n * dma_m - dma_p);
  const T xi = p.nu2 + mu_t1 * mu_t1;
  const T inv_xi = colf / xi;
  T a_new = (gv * nu_a - hv * mu_t1) * inv_xi;
  T b_new = (gv * mu_t1 + hv * nu_b) * inv_xi;

  if (MAIN) {
    a_new = a_new + ghost_gate * a0_ghost[idx];
  } else if (m == g.M + 1) {
    // stale column M+1 (4-buffer rotation): restore the carried edge,
    // retire the pre-step value for the next step
    a_new = edge_a[n];
    b_new = edge_b[n];
    edge_a[n] = a_src;
    edge_b[n] = b_src;
  }
  a_dst[idx] = a_new;
  b_dst[idx] = b_new;
}

// The update of one cell from what it reads, in half_step_cell's operand
// order (the C order, src/boltzmann_c_solver.c:363-378): mu_t, mu_t1 and
// the row and column factors come from the caller, which may hoist them
// (stepper_stream.cu computes each column's mu part once per half-step
// and multiplies it by the row's n as half_step_cell does).  Returns the
// values before the ghost fill and the edge swap.
template <typename T>
__device__ __forceinline__ void cell_update(
    T a_src, T b_src, T dmb_p, T dmb_m, T dma_p, T dma_m, T a0v, T mu_t,
    T mu_t1, T nu_a, T nu_b, T n_ge2, T w_n, T colf, const Params<T>& p,
    T& a_new, T& b_new) {
  const T gv = p.dt * a0v + a_src * p.nu_tilde - b_src * mu_t +
               p.bdt * (dmb_p - n_ge2 * dmb_m);
  const T hv = b_src * p.nu_tilde + a_src * mu_t +
               p.bdt * (w_n * dma_m - dma_p);
  const T xi = p.nu2 + mu_t1 * mu_t1;
  const T inv_xi = colf / xi;
  a_new = (gv * nu_a - hv * mu_t1) * inv_xi;
  b_new = (gv * mu_t1 + hv * nu_b) * inv_xi;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of K values; the result is valid in thread 0.  Every
// thread of the block must call it.  A caller that calls it again must
// pass a __syncthreads() first (warp 0 reads the scratch after the
// barrier inside).
template <typename T, int K>
__device__ __forceinline__ void block_sums(T (&v)[K]) {
  __shared__ T sh[K][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0)
    for (int k = 0; k < K; ++k) sh[k][warp] = v[k];
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    for (int k = 0; k < K; ++k) v[k] = warp_sum(lane < nw ? sh[k][lane] : T(0));
  }
}

// av() (reference src/boltzmann_c_solver.c:413-437) from the three raw
// sums: count, incremental means of v_dr, v_y, m_x, and the Kahan-
// compensated absorption quadratures (compensations in av[6], av[7]).
template <typename T>
__device__ __forceinline__ void av_chain(T* av, T v_dr, T v_y, T m_x,
                                         T cos_av, T sin_av, T dt) {
  const T count = av[0] + T(1);
  av[1] = av[1] + (v_dr - av[1]) / count;
  av[2] = av[2] + (v_y - av[2]) / count;
  av[3] = av[3] + (m_x - av[3]) / count;
  const T y4 = cos_av * v_dr * dt - av[6];
  const T t4 = av[4] + y4;
  av[6] = (t4 - av[4]) - y4;
  av[4] = t4;
  const T y5 = sin_av * v_dr * dt - av[7];
  const T t5 = av[5] + y5;
  av[7] = (t5 - av[5]) - y5;
  av[5] = t5;
  av[0] = av[0] + T(1);
}

}  // namespace slb
