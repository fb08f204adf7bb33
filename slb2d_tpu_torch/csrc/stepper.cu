// Full solver steps on an NVIDIA Hopper card (sm_90a), float and double.
//
// Replaces the Pallas TPU megakernel slb2d_tpu/ops/stepper_pallas.py:_kernel
// (kernel B1).  It computes what B1 computes for each step i of a chunk:
//   1. the main-grid half-step (use_reciprocal form of
//      slb2d_tpu/ops/stencil.py:apply_half_step) advancing a, b against the
//      staggered a_hs, b_hs;
//   2. the parity ghost fill a += gf * a0_ghost, gf = 1 when
//      (i + parity0 + 1) % 2 == 0 (main buffer 0 keeps a0's ghost cells);
//   3. the half-grid half-step advancing a_hs, b_hs against the NEW a, b;
//   4. the stale column M+1 of the half-step arrays: the value just
//      computed there is replaced by the carried edge, and the pre-step
//      value becomes the next carried edge;
//   5. the Kahan-compensated av() update, gated by xs lane 6;
//   6. display-77 records: the PRE-step sums and loop t, plus the
//      POST-step av, at the steps the host names.
//
// What bounds it on the H100: memory traffic.  A half-step reads 5-6
// (NHP, MP) arrays (the pair it advances, the neighbour pair, a0, and
// a0_ghost on the main grid) and writes 2; at BASELINE #4 (NHP=104,
// MP=4096, 1.7 MB per float array) that is ~25 MB per full step, and the
// whole working set (~10 MB) sits in the 50 MB L2 cache.  Measured there
// in float (H100 80GB HBM3, 700 W): 4.2 + 4.9 us for the two half-steps
// (~2.7 TB/s), 2.9 us for the one-block av_step, 15.3 us per step end to
// end -- launch gaps and av_step, not bandwidth, bound this version.
//
// Design: B1 keeps the whole state in one TPU core's VMEM for hundreds of
// steps.  On Hopper one block holds at most 227 KB of shared memory and
// blocks run in no order, and each step needs two grid-wide barriers (the
// half-grid half-step reads the new main arrays at n±1, m±1) plus a
// grid-wide reduction (av).  So each step is three launches on one stream
// -- half_step<MAIN>, half_step<HALF>, av_step -- with the kernel
// boundaries as the barriers, and the host loop over a chunk's steps runs
// in C.  Persistent grid-synchronised kernels, CUDA graphs and temporal
// blocking are later work.
//
// Per-step trig and gates come from a device copy of the chunk's xs table
// (lane order: slb2d_tpu_torch/ops/stepper_cuda.py XS_LANES); physics
// scalars arrive by value in SCALAR_FIELDS order.

#include <cuda_runtime.h>

#include "half_step.cuh"

namespace {

using slb::Geometry;
using slb::Params;
using slb::XS_LANES;

constexpr int OBS_LANES = 16;
constexpr int HALF_BLOCK = 256;
constexpr int SUM_BLOCK = 1024;

// One stencil application over the whole grid, one thread per cell.  The
// in-place update is safe across the grid: the cell reads dst only at its
// own (n, m) and every neighbour from the other pair (nb), which no
// thread of this launch writes.
template <typename T, bool MAIN>
__global__ void half_step(T* __restrict__ a_dst, T* __restrict__ b_dst,
                          const T* __restrict__ a_nb,
                          const T* __restrict__ b_nb,
                          const T* __restrict__ a0,
                          const T* __restrict__ a0_ghost,
                          const T* __restrict__ phi,
                          const T* __restrict__ xs_row, Params<T> p,
                          Geometry g, T ghost_gate,
                          T* __restrict__ edge_a, T* __restrict__ edge_b) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (m >= g.MP || n >= g.NHP) return;
  slb::half_step_cell<T, MAIN>(a_dst, b_dst, a_nb, b_nb, a0, a0_ghost, phi,
                               xs_row[MAIN ? 0 : 2], xs_row[MAIN ? 1 : 3],
                               p, g, ghost_gate, edge_a, edge_b, n, m);
}

// av() (reference src/boltzmann_c_solver.c:413-437) on the post-step main
// arrays, one block.  When obs_slot is set, the post-step av is copied
// into the display-77 record after the update.
template <typename T>
__global__ void av_step(const T* __restrict__ a, const T* __restrict__ b,
                        const T* __restrict__ w_av,
                        const T* __restrict__ w_av_phi, int MP,
                        const T* __restrict__ xs_row, T dt, T* av,
                        T* obs_slot) {
  if (xs_row[6] > T(0)) {
    T s[3] = {T(0), T(0), T(0)};
    for (int m = threadIdx.x; m < MP; m += blockDim.x) {
      s[0] += b[MP + m] * w_av[m];      // v_dr
      s[1] += a[m] * w_av_phi[m];       // v_y
      s[2] += a[MP + m] * w_av[m];      // m_x
    }
    slb::block_sums<T, 3>(s);
    if (threadIdx.x == 0)
      slb::av_chain(av, s[0], s[1], s[2], xs_row[4], xs_row[5], dt);
  }
  if (obs_slot != nullptr && threadIdx.x == 0)
    for (int j = 0; j < 8; ++j) obs_slot[5 + j] = av[j];
}

// Display-77 record, PRE-step part: run before the step's main half-step
// (the in-place update destroys the pre-step arrays).
template <typename T>
__global__ void record_step(const T* __restrict__ a, const T* __restrict__ b,
                            const T* __restrict__ w_av,
                            const T* __restrict__ w_av_phi, int MP,
                            const T* __restrict__ xs_row, T* obs_slot) {
  T s[4] = {T(0), T(0), T(0), T(0)};
  for (int m = threadIdx.x; m < MP; m += blockDim.x) {
    s[0] += a[m] * w_av[m];             // norm
    s[1] += b[MP + m] * w_av[m];        // v_dr
    s[2] += a[m] * w_av_phi[m];         // v_y
    s[3] += a[MP + m] * w_av[m];        // m_x
  }
  slb::block_sums<T, 4>(s);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) obs_slot[k] = s[k];
    obs_slot[4] = xs_row[7];
  }
}

template <typename T>
int run_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
              const T* a0, const T* a0_ghost, const T* phi, const T* w_av,
              const T* w_av_phi, const T* params, const T* xs, T* obs,
              const int* emit, int n_emit, int N, int M, int NHP, int MP,
              int n_steps, int parity0, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params<T> p = {params[0], params[1], params[2], params[3],
                       params[4], params[5], params[6], params[7],
                       params[8], params[9], params[10]};
  const Geometry g = {N, M, NHP, MP};
  const dim3 blk(HALF_BLOCK), grd((MP + HALF_BLOCK - 1) / HALF_BLOCK, NHP);
  cudaError_t err;
  int e = 0;
  for (int i = 0; i < n_steps; ++i) {
    const T* row = xs + (size_t)i * XS_LANES;
    T* slot = nullptr;
    if (e < n_emit && emit[e] == i) {
      slot = obs + (size_t)e * OBS_LANES;
      ++e;
      record_step<T><<<1, SUM_BLOCK, 0, s>>>(a, b, w_av, w_av_phi, MP, row,
                                             slot);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    const T gf = ((i + parity0 + 1) % 2 == 0) ? T(1) : T(0);
    half_step<T, true><<<grd, blk, 0, s>>>(a, b, a_hs, b_hs, a0, a0_ghost,
                                           phi, row, p, g, gf, nullptr,
                                           nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    half_step<T, false><<<grd, blk, 0, s>>>(a_hs, b_hs, a, b, a0, a0_ghost,
                                            phi, row, p, g, T(0), edge_a,
                                            edge_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    av_step<T><<<1, SUM_BLOCK, 0, s>>>(a, b, w_av, w_av_phi, MP, row, p.dt,
                                       av, slot);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// C entry points (bound with ctypes in ops/stepper_cuda.py).  Every array
// pointer is a device pointer except `params` (16 host values in
// SCALAR_FIELDS order) and `emit` (n_emit ascending in-chunk step indices,
// host).  They enqueue 3 launches per step (+1 per emission record) on
// `stream`, do not synchronise, and return 0 or the first cudaError_t.
extern "C" int slb_run_chunk_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* params,
    const void* xs, void* obs, const void* emit, int n_emit, int N, int M,
    int NHP, int MP, int n_steps, int parity0, void* stream) {
  using T = float;
  return run_chunk<T>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      (const T*)a0, (const T*)a0_ghost, (const T*)phi, (const T*)w_av,
      (const T*)w_av_phi, (const T*)params, (const T*)xs, (T*)obs,
      (const int*)emit, n_emit, N, M, NHP, MP, n_steps, parity0, stream);
}

extern "C" int slb_run_chunk_f64(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* params,
    const void* xs, void* obs, const void* emit, int n_emit, int N, int M,
    int NHP, int MP, int n_steps, int parity0, void* stream) {
  using T = double;
  return run_chunk<T>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      (const T*)a0, (const T*)a0_ghost, (const T*)phi, (const T*)w_av,
      (const T*)w_av_phi, (const T*)params, (const T*)xs, (T*)obs,
      (const int*)emit, n_emit, N, M, NHP, MP, n_steps, parity0, stream);
}
