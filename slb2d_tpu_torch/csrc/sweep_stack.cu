// A chunk of full steps for a whole batch of sweep points on an NVIDIA
// Hopper card (sm_90a), float and double.
//
// Replaces the Pallas TPU kernel slb2d_tpu/ops/sweep_stack.py:_kernel
// (kernel B3) in its shared-omega mode.  For every point p and every step
// i of a chunk it computes what B3 computes with per_omega=False:
//   1. the main-grid half-step (use_reciprocal form of
//      slb2d_tpu/ops/stencil.py:apply_half_step) with p's own E_dc,
//      E_omega, B and bdt, and p's own a0 when a0 is batched (mu or alpha
//      swept);
//   2. the parity ghost fill a += gf * a0_ghost, gf = 1 when
//      (i + parity0 + 1) % 2 == 0;
//   3. the half-grid half-step against the NEW a, b;
//   4. the stale column M+1 of p's half-step arrays: the value just
//      computed there is replaced by p's carried edge, and the pre-step
//      value becomes the next carried edge;
//   5. p's Kahan-compensated av() update, gated by xs lane 6 (the shared
//      time window) AND p's egate (E_omega > 0): a dc-only point's av
//      stays exactly zero.
// dt, nu, nu2, nu_tilde and the trig of the chunk's exact xs table are
// shared by all points (omega is not swept in this mode).  B3's per-omega
// mode (in-kernel trig chains, per-point windows, in-kernel loop-exit
// capture) is not ported here.
//
// Design: sweep points are independent, as B3 exploits by keeping a point
// group resident in VMEM for a whole chunk.  Here ONE thread block owns
// one point for the whole chunk and loops over its steps, so the batch is
// one launch per chunk.  __syncthreads() takes the place of B1's kernel
// boundaries (stepper.cu):
//   - phase A, the main half-step, writes a, b in place and reads only
//     a_hs, b_hs as neighbours;
//   - barrier;
//   - phase B, the half-grid half-step, writes a_hs, b_hs in place and
//     reads the new a, b as neighbours; the av sums read rows 0 and 1 of
//     the new a, b, which phase B does not write, so they run in the same
//     phase, after the thread's half-step cells;
//   - barrier: the next step's phase A reads a_hs, b_hs at n±1, m±1 and
//     overwrites the a, b the sums read.
// B3's "columnar" av (every stacked row carries its own chain) is a VMEM
// layout trick; a per-point block reduction of the three sums computes
// the same observables, and thread 0 keeps p's av in registers across
// the chunk.
//
// What bounds it on the H100: at the 64-point sweep shape (NHP=48,
// MP=512) a point is 24,576 cells per array, 24 cells per thread at 1024
// threads, and its four state arrays (393 KB in float) plus a0 stay in
// the 50 MB L2 for the whole batch (~38 MB).  Each step streams ~10 array
// passes per point through L2 from one SM per point, so L2 bandwidth per
// SM and the two barriers per step bound it.  64 points fill 64 of the
// 132 SMs and leave the rest idle; splitting a point over a cluster of
// blocks to fill the card is later work.

#include <cuda_runtime.h>

#include "half_step.cuh"

namespace {

using slb::Geometry;
using slb::Params;
using slb::XS_LANES;

constexpr int SWEEP_BLOCK = 1024;

// per-point columns (lane order: slb2d_tpu_torch/ops/sweep_stack_cuda.py)
constexpr int PP_COLS = 8;
constexpr int PP_EDC = 0, PP_EOM = 1, PP_B = 2, PP_BDT = 3, PP_EGATE = 4;

// scalars every point shares (sweep_stack_cuda.py SCALAR_FIELDS order)
template <typename T>
struct Shared {
  T dt, nu, nu2, nu_tilde;
};

// The state arrays carry no __restrict__: each is written in one phase
// and read by other threads in the next, so none may be read through the
// read-only cache path.
template <typename T>
__global__ void __launch_bounds__(SWEEP_BLOCK)
    sweep_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
                const T* __restrict__ a0, const T* __restrict__ a0_ghost,
                size_t a0_stride, const T* __restrict__ phi,
                const T* __restrict__ w_av, const T* __restrict__ w_av_phi,
                const T* __restrict__ pp, Shared<T> s,
                const T* __restrict__ xs, Geometry g, int n_steps,
                int parity0) {
  const int pt = blockIdx.x;
  const int MP = g.MP;
  const int ncell = g.NHP * MP;
  const size_t off = (size_t)pt * ncell;
  a += off;
  b += off;
  a_hs += off;
  b_hs += off;
  edge_a += (size_t)pt * g.NHP;
  edge_b += (size_t)pt * g.NHP;
  a0 += pt * a0_stride;
  a0_ghost += pt * a0_stride;
  T* av_p = av + (size_t)pt * 8;

  const T* q = pp + (size_t)pt * PP_COLS;
  const Params<T> p = {q[PP_EDC], q[PP_EOM], T(0),      q[PP_B],
                       s.dt,      s.nu,      s.nu2,     s.nu_tilde,
                       q[PP_BDT], T(0),      T(0)};
  const bool egate = q[PP_EGATE] > T(0);

  T r[8] = {};   // p's av, live in thread 0 only
  if (threadIdx.x == 0)
    for (int j = 0; j < 8; ++j) r[j] = av_p[j];

  for (int i = 0; i < n_steps; ++i) {
    const T* row = xs + (size_t)i * XS_LANES;
    const T gf = ((i + parity0 + 1) % 2 == 0) ? T(1) : T(0);

    // phase A: main grid
    const T cos_t = row[0], cos_t_dt = row[1];
    for (int k = threadIdx.x; k < ncell; k += SWEEP_BLOCK) {
      const int n = k / MP, m = k - n * MP;
      slb::half_step_cell<T, true>(a, b, a_hs, b_hs, a0, a0_ghost, phi,
                                   cos_t, cos_t_dt, p, g, gf, nullptr,
                                   nullptr, n, m);
    }
    __syncthreads();

    // phase B: half grid, then this point's av sums
    const T cos_hs = row[2], cos_hs_dt = row[3];
    for (int k = threadIdx.x; k < ncell; k += SWEEP_BLOCK) {
      const int n = k / MP, m = k - n * MP;
      slb::half_step_cell<T, false>(a_hs, b_hs, a, b, a0, a0_ghost, phi,
                                    cos_hs, cos_hs_dt, p, g, T(0), edge_a,
                                    edge_b, n, m);
    }
    if (egate && row[6] > T(0)) {   // uniform across the block
      T sums[3] = {T(0), T(0), T(0)};
      for (int m = threadIdx.x; m < MP; m += SWEEP_BLOCK) {
        sums[0] += b[MP + m] * w_av[m];      // v_dr
        sums[1] += a[m] * w_av_phi[m];       // v_y
        sums[2] += a[MP + m] * w_av[m];      // m_x
      }
      slb::block_sums<T, 3>(sums);
      if (threadIdx.x == 0)
        slb::av_chain(r, sums[0], sums[1], sums[2], row[4], row[5], s.dt);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0)
    for (int j = 0; j < 8; ++j) av_p[j] = r[j];
}

template <typename T>
int run_sweep_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b,
                    T* av, const T* a0, const T* a0_ghost, const T* phi,
                    const T* w_av, const T* w_av_phi, const T* pp,
                    const T* params, const T* xs, int n_points,
                    int a0_batched, int N, int M, int NHP, int MP,
                    int n_steps, int parity0, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shared<T> s = {params[0], params[1], params[2], params[3]};
  const Geometry g = {N, M, NHP, MP};
  const size_t a0_stride = a0_batched ? (size_t)NHP * MP : 0;
  sweep_chunk<T><<<n_points, SWEEP_BLOCK, 0, st>>>(
      a, b, a_hs, b_hs, edge_a, edge_b, av, a0, a0_ghost, a0_stride, phi,
      w_av, w_av_phi, pp, s, xs, g, n_steps, parity0);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes in ops/sweep_stack_cuda.py).  Every
// array pointer is a device pointer except `params` (4 host values in
// SCALAR_FIELDS order).  State arrays are (n_points, NHP, MP), edges
// (n_points, NHP), av (n_points, 8), pp (n_points, PP_COLS); a0 and
// a0_ghost are (n_points, NHP, MP) when a0_batched, else (NHP, MP).  They
// enqueue ONE launch on `stream`, do not synchronise, and return 0 or the
// cudaError_t of the launch.
extern "C" int slb_sweep_chunk_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, void* stream) {
  using T = float;
  return run_sweep_chunk<T>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      (const T*)a0, (const T*)a0_ghost, (const T*)phi, (const T*)w_av,
      (const T*)w_av_phi, (const T*)pp, (const T*)params, (const T*)xs,
      n_points, a0_batched, N, M, NHP, MP, n_steps, parity0, stream);
}

extern "C" int slb_sweep_chunk_f64(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, void* stream) {
  using T = double;
  return run_sweep_chunk<T>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      (const T*)a0, (const T*)a0_ghost, (const T*)phi, (const T*)w_av,
      (const T*)w_av_phi, (const T*)pp, (const T*)params, (const T*)xs,
      n_points, a0_batched, N, M, NHP, MP, n_steps, parity0, stream);
}
