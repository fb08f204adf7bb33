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
// B1 keeps the whole state in one TPU core's VMEM for hundreds of steps.
// On Hopper no SM holds it, but the card's 132 SMs together do (30.7 MB
// of shared memory).  Each step needs two grid-wide barriers (the
// half-grid half-step reads the new main arrays at n±1, m±1) and a
// grid-wide reduction (av).  Two forms compute the same function;
// ops/stepper_cuda.py:resident_plan picks one before anything launches:
//
//   Resident form (resident_chunk; slb_resident_chunk_*; its body is
//   resident_band_chunk in band_step.cuh, which shares its cell code with
//   stepper_stream.cu's spill form): ONE cooperative launch per chunk, one
//   block per SM.  Block k owns the band of columns [k·W, min((k+1)·W,
//   MP)) of all NHP rows of a, b, a_hs and b_hs in dynamic shared memory,
//   with halo columns: the state crosses device memory twice per chunk
//   (loaded at its start, written back at its end).  Row neighbours, the
//   row wrap included, are the band's own rows; only the m±1 halo crosses
//   bands: the band runs the main half-step on its own columns AND on the
//   one a, b halo column on each side (what its neighbours compute as
//   their own columns, from the same inputs, so the same bits), which
//   needs a_hs, b_hs two columns deep; then the half-grid half-step on its
//   own columns, publishing its first two and last two columns of a_hs,
//   b_hs (8·NHP values) to the exchange buffer xch, from which the
//   neighbours read their a_hs, b_hs halo (the column wrap of the plain
//   version: band 0's left neighbour is the last band).  Only the
//   half-grid half-step's four outer columns feed the neighbours, so a
//   step is split around a grid barrier of its own, one counter in device
//   memory (band_step.cuh: resident_band_chunk): the main half-step; the
//   half-grid half-step's edges, published; the arrival; its interior,
//   which runs while the edges travel; the wait, usually open by then; the
//   halo read.  xch is double-buffered by step parity, so no band
//   overwrites values a slower neighbour has still to read.  The bands'
//   partial sums of rows 0 and 1 (norm, v_dr, v_y, m_x) go to `part`
//   (PART_SLOTS steps deep) before the arrival; block 0's next-to-last
//   warp adds them during the next step's half-grid interior, off the
//   barrier's path, in a fixed order (lane l the bands l, l+32, ... in
//   order, then a shuffle tree); its lane 0 runs the av chain with av in
//   registers across the chunk, and writes the display-77 records: the
//   PRE-step sums of step i are the post-step sums of step i-1, so one set
//   of partials serves both.  The sum order differs from av_step's: av
//   and records agree to rounding, the state and edges bit for bit.  The
//   xs table is staged in shared memory XS_STAGE rows at a time.
//   The cell loop: warp lanes on neighbouring columns (shared reads free
//   of bank conflicts at any row stride), each thread the same column and
//   rows r0, r0+RW, ... in both half-steps (the half-grid one's edge
//   columns and the main one's halo columns one cell a thread from the
//   block's last, by the general cell); the column's mu parts and
//   masks once per half-step, 32-bit offsets, no column wrap inside a
//   band; rows 2..N-1 without row masks or wraps (their terms are
//   constants); a0 read through the read-only path (L2), a0_ghost only off
//   the interior (rows >= N, columns 0 and >= M+2), where the model keeps
//   it nonzero, loaded before the cell's arithmetic; elsewhere it is 0 and
//   the ghost fill adds gf·0 as before.
//   Shapes whose band does not fit (f64 at the tall and wide grids) take
//   the per-half-step form; nothing falls back at run time.
//
//   Per-half-step form (run_chunk; slb_run_chunk_*): each step is three
//   launches on one stream -- half_step<MAIN>, half_step<HALF>, av_step --
//   with the kernel boundaries as the barriers, one thread per cell, the
//   state in device memory (L2), and the host loop over a chunk's steps
//   in C.  At BASELINE #4 in float (H100 80GB HBM3, 700 W): 4.2 + 4.9 us
//   for the two half-steps (~2.7 TB/s), 2.9 us for the one-block
//   av_step, 15.3 us per step end to end: launch gaps and av_step, not
//   bandwidth, bound it.
//
// What bounds the work on the H100: its arithmetic, 28 adds, multiplies
// and divisions per live cell of a half-step against the data sheet's
// 67e12 f32 FLOP/s (benchmark/harness/roofline.py, PERF.md §6); the bytes, the state read once and written once per chunk, are
// smaller.  The per-half-step form walks the state through L2 every
// half-step; the resident form removes the walk, and what is left is each
// SM's cell loop and what of a step's barrier and halo read its interior
// cells do not hide (PERF.md §5).
//
// Per-step trig and gates come from a device copy of the chunk's xs table
// (lane order: slb2d_tpu_torch/ops/stepper_cuda.py XS_LANES; lanes 8-9
// the display-77 flag and record slot); physics scalars arrive by value
// in SCALAR_FIELDS order.

#include <cuda_runtime.h>

#include "band_step.cuh"
#include "half_step.cuh"

namespace {

using slb::BAND_ALIGN;
using slb::Geometry;
using slb::MAX_BAND;
using slb::NOT_CO_RESIDENT;
using slb::OBS_LANES;
using slb::Params;
using slb::RESIDENT_BLOCK;
using slb::RESIDENT_SCRATCH;
using slb::SMEM_LIMIT;
using slb::XS_LANES;
using slb::resident_smem_bytes;
using slb::resident_threads;

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

// ---- the resident form -----------------------------------------------

// The resident form: resident_band_chunk (band_step.cuh), bands of W
// columns.
template <typename T>
__global__ void __launch_bounds__(RESIDENT_BLOCK, 1)
    resident_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
                   const T* __restrict__ a0, const T* __restrict__ a0_ghost,
                   const T* __restrict__ phi, const T* __restrict__ w_av,
                   const T* __restrict__ w_av_phi, const T* __restrict__ xs,
                   T* obs, T* xch, T* part, unsigned* sync,
                   long long* tally, Params<T> p, Geometry g, int W,
                   int n_steps, int parity0) {
  slb::resident_band_chunk<T>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                              a0_ghost, phi, w_av, w_av_phi, xs, obs, xch,
                              part, sync, tally, p, g, W, n_steps, parity0);
}

// cudaSuccess, or why bands of W columns cannot hold an (NHP, MP) state:
// W not a multiple of BAND_ALIGN up to MAX_BAND, fewer than 2 rows, or
// the band and the row sums' scratch past SMEM_LIMIT
template <typename T>
cudaError_t check_band(int W, int NHP, int MP) {
  if (W < BAND_ALIGN || W > MAX_BAND || W % BAND_ALIGN != 0 || NHP < 2 ||
      MP < 1)
    return cudaErrorInvalidValue;
  if (resident_smem_bytes<T>(NHP, W) + RESIDENT_SCRATCH * sizeof(T) >
      (size_t)SMEM_LIMIT)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The resident form's launch shape for bands of W columns: the kernel's
// shared-memory attribute set, and the blocks the card runs at once
template <typename T>
cudaError_t resident_config(int W, int NHP, int MP, int* at_once) {
  cudaError_t err = check_band<T>(W, NHP, MP);
  if (err != cudaSuccess) return err;
  const int smem = (int)resident_smem_bytes<T>(NHP, W);
  err = cudaFuncSetAttribute(resident_chunk<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, resident_chunk<T>, resident_threads(W), smem)) !=
          cudaSuccess)
    return err;
  *at_once = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
int run_resident(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
                 const T* a0, const T* a0_ghost, const T* phi,
                 const T* w_av, const T* w_av_phi, const T* params,
                 const T* xs, T* obs, T* xch, T* part, unsigned* sync,
                 long long* tally, int N, int M, int NHP, int MP, int W,
                 int n_steps, int parity0, void* stream) {
  Params<T> p = {params[0], params[1], params[2], params[3],
                 params[4], params[5], params[6], params[7],
                 params[8], params[9], params[10]};
  Geometry g = {N, M, NHP, MP};
  int at_once = 0;
  cudaError_t err = resident_config<T>(W, NHP, MP, &at_once);
  if (err != cudaSuccess) return (int)err;
  const int bands = (MP + W - 1) / W;
  if (at_once < bands) return NOT_CO_RESIDENT;
  void* args[] = {&a,   &b,        &a_hs,   &b_hs, &edge_a,   &edge_b,
                  &av,  &a0,       &a0_ghost, &phi, &w_av,    &w_av_phi,
                  &xs,  &obs,      &xch,    &part, &sync,     &tally,
                  &p,   &g,        &W,      &n_steps, &parity0};
  err = cudaLaunchCooperativeKernel(
      (const void*)resident_chunk<T>, dim3(bands), dim3(resident_threads(W)),
      args, resident_smem_bytes<T>(NHP, W),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the resident form takes on this card: out[0] registers a thread,
// out[1] local (spill) bytes a thread, out[2] dynamic shared memory a
// block, out[3] blocks that run at once on the whole card, out[4] threads
// a block, out[5] static shared memory a block
template <typename T>
int resident_info(int W, int NHP, int MP, int* out) {
  int at_once = 0;
  cudaError_t err = resident_config<T>(W, NHP, MP, &at_once);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, resident_chunk<T>)) != cudaSuccess)
    return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)resident_smem_bytes<T>(NHP, W);
  out[3] = at_once;
  out[4] = resident_threads(W);
  out[5] = (int)fa.sharedSizeBytes;
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

// The resident form's entry points: the arguments of slb_run_chunk_*
// without emit (xs lanes 8-9 carry the records) and with the exchange
// buffer xch (2 x bands x XCH_LANES x NHP values), the partials part
// (PART_SLOTS x bands x PART_LANES) and the barrier's words sync
// (SYNC_WORDS + 2 x bands unsigned ints, zero before the first launch; the
// kernel leaves its first SYNC_WORDS zero and each band's waits and open
// waits after them) and the bands' cycle tally (B1_TALLY x bands int64
// words, which each launch overwrites: a band's step-loop cycles and its
// exposed cycles), all device scratch, and the band width W.  They
// enqueue ONE cooperative launch of ceil(MP / W) blocks on `stream`, do
// not synchronise, and return 0, the cudaError_t of a refused launch
// (cudaErrorInvalidValue for bands that cannot hold the state), or
// NOT_CO_RESIDENT; a refused launch changes nothing.
template <typename T>
int resident_entry(void* a, void* b, void* a_hs, void* b_hs, void* edge_a,
                   void* edge_b, void* av, const void* a0,
                   const void* a0_ghost, const void* phi, const void* w_av,
                   const void* w_av_phi, const void* params, const void* xs,
                   void* obs, void* xch, void* part, void* sync, void* tally,
                   int N, int M, int NHP, int MP, int W, int n_steps,
                   int parity0, void* stream) {
  return run_resident<T>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      (const T*)a0, (const T*)a0_ghost, (const T*)phi, (const T*)w_av,
      (const T*)w_av_phi, (const T*)params, (const T*)xs, (T*)obs, (T*)xch,
      (T*)part, (unsigned*)sync, (long long*)tally, N, M, NHP, MP, W, n_steps,
      parity0, stream);
}

extern "C" int slb_resident_chunk_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* params,
    const void* xs, void* obs, void* xch, void* part, void* sync,
    void* tally, int N, int M, int NHP, int MP, int W, int n_steps,
    int parity0, void* stream) {
  return resident_entry<float>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                               a0_ghost, phi, w_av, w_av_phi, params, xs,
                               obs, xch, part, sync, tally, N, M, NHP, MP,
                               W, n_steps, parity0, stream);
}

extern "C" int slb_resident_chunk_f64(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* params,
    const void* xs, void* obs, void* xch, void* part, void* sync,
    void* tally, int N, int M, int NHP, int MP, int W, int n_steps,
    int parity0, void* stream) {
  return resident_entry<double>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                                a0_ghost, phi, w_av, w_av_phi, params, xs,
                                obs, xch, part, sync, tally, N, M, NHP,
                                MP, W, n_steps, parity0, stream);
}

// resident_info for float or double; returns 0 or the cudaError_t of the
// query (cudaErrorInvalidValue for bands that cannot hold the state)
extern "C" int slb_resident_info(int f64, int W, int NHP, int MP, int* out) {
  return f64 ? resident_info<double>(W, NHP, MP, out)
             : resident_info<float>(W, NHP, MP, out);
}
