// The step kernel B1's full step (av off) in the transposed (m, n) layout
// on an NVIDIA Hopper card (sm_90a), float32.
//
// Replaces the Pallas TPU probe tests/perf/transposed_experiment.py
// `_kernel_T` (probe P3): the state arrays are (MP, NHL), m on the slow
// axis and the harmonic n on the fast one, padded from NHP to NHL columns
// (NHL = 128 at N = 100: 104 of 128 live).  Each step i of a chunk is B1's
// (csrc/stepper.cu, steps 1-4): the main half-step, the parity ghost fill
// (gf = 1 when (i + parity0 + 1) % 2 == 0), the half-grid half-step
// against the new main arrays, and the stale column M+1 of the half-step
// arrays from the carried edges.  Unlike the JAX probe, which restores a
// one-step-old edge and hard-codes the physics scalars, this is B1's real
// step with the model's scalars: transposed back, its state equals B1's
// plain version (ops/stepper_cuda.py:run_chunk_plain, av off) bit for bit.
//
// The arithmetic is half_step.cuh's cell_update in half_step_cell's operand
// order; only the indices differ.  Consecutive threads run along n, so a
// warp reads n-1, n, n+1 of one row m; m±1 is a stride of NHL.  n±1 wraps
// at NHP and m±1 at MP, as in B1 (the wrapped values land only where the
// masks zero them).  The padding columns n >= NHP are never written.
//
// What bounds it: as B1, L2 traffic and the two launches per step (each
// half-step reads 5-6 (MP, NHL) arrays and writes 2: ~2.1 MB per array at
// BASELINE #4, 23% more than B1's (NHP, MP) arrays).  Two launches per
// step, the kernel boundary as the barrier between the half-steps.

#include <cuda_runtime.h>

#include "half_step.cuh"

namespace {

using slb::Params;
using slb::XS_LANES;

constexpr int BLOCK = 256;

struct TGeometry {
  int N, M, NHP, MP, NHL;
};

// One stencil application over the whole transposed grid, one thread per
// padded cell (n, m) = (t % NHL, t / NHL).  In place: a cell reads dst only
// at its own (m, n) and every neighbour from the other pair (nb).
template <bool MAIN>
__global__ void t_half_step(float* __restrict__ a_dst,
                            float* __restrict__ b_dst,
                            const float* __restrict__ a_nb,
                            const float* __restrict__ b_nb,
                            const float* __restrict__ a0,
                            const float* __restrict__ a0_ghost,
                            const float* __restrict__ phi,
                            const float* __restrict__ xs_row,
                            Params<float> p, TGeometry g, float ghost_gate,
                            float* __restrict__ edge_a,
                            float* __restrict__ edge_b) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = t % g.NHL, m = t / g.NHL;
  if (n >= g.NHP || m >= g.MP) return;
  const size_t idx = (size_t)m * g.NHL + n;
  const float cos_t = xs_row[MAIN ? 0 : 2];
  const float cos_t_dt = xs_row[MAIN ? 1 : 3];

  // half_step_cell's row and column factors
  const float nf = n < g.N ? float(n) : 0.0f;
  const float n_ge2 = n >= 2 ? 1.0f : 0.0f;
  const float w_n = n == 0 ? 0.0f : (n == 1 ? 2.0f : 1.0f);
  const float nu_a = p.nu * (n < g.N ? 1.0f : 0.0f);
  const float nu_b = nu_a * (n > 0 ? 1.0f : 0.0f);
  const int m_hi = MAIN ? g.M + 1 : g.M;
  const float colf = (m >= 1 && m <= m_hi) ? 1.0f : 0.0f;
  const float ph = phi[m];
  const float mu_t =
      nf * ((p.E_dc + p.E_omega * cos_t + p.B * ph) * p.dt / 2.0f);
  const float mu_t1 =
      nf * ((p.E_dc + p.E_omega * cos_t_dt + p.B * ph) * p.dt / 2.0f);

  // rows m+1 and m-1 of the layout; X[n±1, m+1] - X[n±1, m-1] as in B1
  const int np1 = n + 1 == g.NHP ? 0 : n + 1;
  const int nm1 = n == 0 ? g.NHP - 1 : n - 1;
  const size_t rp = (size_t)(m + 1 == g.MP ? 0 : m + 1) * g.NHL;
  const size_t rm = (size_t)(m == 0 ? g.MP - 1 : m - 1) * g.NHL;
  const float dmb_p = b_nb[rp + np1] - b_nb[rm + np1];
  const float dmb_m = b_nb[rp + nm1] - b_nb[rm + nm1];
  const float dma_p = a_nb[rp + np1] - a_nb[rm + np1];
  const float dma_m = a_nb[rp + nm1] - a_nb[rm + nm1];

  const float a_src = a_dst[idx];
  const float b_src = b_dst[idx];
  float a_new, b_new;
  slb::cell_update(a_src, b_src, dmb_p, dmb_m, dma_p, dma_m, a0[idx], mu_t,
                   mu_t1, nu_a, nu_b, n_ge2, w_n, colf, p, a_new, b_new);
  if (MAIN) {
    a_new = a_new + ghost_gate * a0_ghost[idx];
  } else if (m == g.M + 1) {
    a_new = edge_a[n];
    b_new = edge_b[n];
    edge_a[n] = a_src;
    edge_b[n] = b_src;
  }
  a_dst[idx] = a_new;
  b_dst[idx] = b_new;
}

}  // namespace

// C entry point (bound with ctypes in perf/transposed_experiment.py).
// a, b, a_hs, b_hs, a0, a0_ghost: (MP, NHL) device arrays; edge_a, edge_b:
// (NHP,); phi: (MP,); xs: the chunk's (n_steps, XS_LANES) table on the
// device; params: 16 host values in ops/stepper_cuda.py SCALAR_FIELDS
// order.  Enqueues two launches per step on `stream`, does not
// synchronise, and returns 0 or the first cudaError_t.
extern "C" int slb_transposed_chunk_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    const void* a0, const void* a0_ghost, const void* phi,
    const void* params, const void* xs, int N, int M, int NHP, int MP,
    int NHL, int n_steps, int parity0, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pr = static_cast<const float*>(params);
  const Params<float> p = {pr[0], pr[1], pr[2], pr[3], pr[4], pr[5],
                           pr[6], pr[7], pr[8], pr[9], pr[10]};
  const TGeometry g = {N, M, NHP, MP, NHL};
  const int grid = (MP * NHL + BLOCK - 1) / BLOCK;
  float *A = (float*)a, *Bm = (float*)b, *Ah = (float*)a_hs,
        *Bh = (float*)b_hs;
  const float *A0 = (const float*)a0, *A0g = (const float*)a0_ghost,
              *ph = (const float*)phi;
  for (int i = 0; i < n_steps; ++i) {
    const float* row = (const float*)xs + (size_t)i * XS_LANES;
    const float gf = ((i + parity0 + 1) % 2 == 0) ? 1.0f : 0.0f;
    t_half_step<true><<<grid, BLOCK, 0, s>>>(A, Bm, Ah, Bh, A0, A0g, ph, row,
                                             p, g, gf, nullptr, nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    t_half_step<false><<<grid, BLOCK, 0, s>>>(Ah, Bh, A, Bm, A0, A0g, ph, row,
                                              p, g, 0.0f, (float*)edge_a,
                                              (float*)edge_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
