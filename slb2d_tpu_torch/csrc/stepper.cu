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
//   Resident form (resident_chunk; slb_resident_chunk_*): ONE cooperative
//   launch per chunk, one block per SM.  Block k owns the band of columns
//   [k·W, min((k+1)·W, MP)) of all NHP rows of a, b, a_hs and b_hs in
//   dynamic shared memory, with halo columns: the state crosses device
//   memory twice per chunk (loaded at its start, written back at its
//   end).  Row neighbours, the row wrap included, are the band's own rows;
//   only the m±1 halo crosses bands, and one grid barrier a step carries
//   it: the band runs the main half-step on its own columns AND on the
//   one a, b halo column on each side (what its neighbours compute as
//   their own columns, from the same inputs, so the same bits), which
//   needs a_hs, b_hs two columns deep; then, after a block barrier, the
//   half-grid half-step on its own columns, publishing its first two and
//   last two columns of a_hs, b_hs (8·NHP values) to the exchange buffer
//   xch; after the grid barrier (cooperative_groups' grid sync) it reads
//   its neighbours' into its a_hs, b_hs halo (the column wrap of the plain
//   version: band 0's left neighbour is the last band).  xch is
//   double-buffered by step parity, so no band overwrites values a slower
//   neighbour has still to read.  The bands' partial sums of rows 0 and 1
//   (norm, v_dr, v_y, m_x) go to `part` (also by step parity) after the
//   main half-step; block 0's last warp adds them during the next step's
//   main half-step, off the barrier's path, in a fixed order (lane l the
//   bands l, l+32, ... in order, then a shuffle tree); its lane 0 runs the
//   av chain with av in registers across the chunk, and writes the
//   display-77 records: the PRE-step sums of step i
//   are the post-step sums of step i-1, so one set of partials serves
//   both.  The sum order differs from av_step's: av and records agree to
//   rounding, the state and edges bit for bit.  The xs table is staged in
//   shared memory XS_STAGE rows at a time.
//   The cell loop: warp lanes on neighbouring columns (shared reads free
//   of bank conflicts at any row stride), each thread the same column and
//   rows r0, r0+RW, ... in both half-steps; the column's mu parts and
//   masks once per half-step, 32-bit offsets, no column wrap inside a
//   band; rows 2..N-1 without row masks or wraps (their terms are
//   constants); a0 read through the read-only path (L2), a0_ghost only off
//   the interior (rows >= N, columns 0 and >= M+2), where the model keeps
//   it nonzero; elsewhere it is 0 and the ghost fill adds gf·0 as before.
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
// and divisions per live cell of a half-step at 33.5 T per second, an
// H100's f32 rate without FMA (chip_smoke.py main_path_flops, PERF.md
// §6); the bytes, the state read once and written once per chunk, are
// smaller.  The per-half-step form walks the state through L2 every
// half-step; the resident form removes the walk, and what is left is each
// SM's cell loop and the two barriers of a step (PERF.md §5).
//
// Per-step trig and gates come from a device copy of the chunk's xs table
// (lane order: slb2d_tpu_torch/ops/stepper_cuda.py XS_LANES; lanes 8-9
// the display-77 flag and record slot); physics scalars arrive by value
// in SCALAR_FIELDS order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "half_step.cuh"

namespace cg = cooperative_groups;

namespace {

using slb::Geometry;
using slb::Params;
using slb::XS_LANES;

constexpr int OBS_LANES = 16;
constexpr int HALF_BLOCK = 256;
constexpr int SUM_BLOCK = 1024;

// The resident form's budget (ops/stepper_cuda.py resident_plan mirrors
// these; tests/test_torch_stepper_resident.py holds the two to each
// other): a block's opt-in shared memory on an H100; the halo columns on
// each side of a band's a, b (the band computes their main half-step
// itself) and of its a_hs, b_hs (exchanged; the halo cells' main
// half-step reads them); the xs rows staged at a time (plus the next);
// the band width's unit (a warp's lanes on neighbouring columns) and its
// largest value (two row groups at least, so rows 0 and 1 lie in
// different warps), the largest block, and the static scratch of the row
// sums (elements: 2 rows x MAX_BAND / BAND_ALIGN warps x 2 values).
constexpr int SMEM_LIMIT = 232448;
constexpr int HALO_MAIN = 1;
constexpr int HALO_HALF = 2;
constexpr int XS_STAGE = 32;
constexpr int BAND_ALIGN = 32;
constexpr int MAX_BAND = 512;
constexpr int RESIDENT_BLOCK = 1024;
constexpr int SUM_WARPS = MAX_BAND / BAND_ALIGN;
constexpr int RESIDENT_SCRATCH = 2 * SUM_WARPS * 2;
// the partial sums a band leaves per step: norm, v_dr, v_y, m_x
constexpr int PART_LANES = 4;
// the values a band publishes per row and step: its first two and last
// two columns of a_hs and b_hs
constexpr int XCH_LANES = 8;
// returned when the card cannot run every band's block at once
constexpr int NOT_CO_RESIDENT = -2;

template <typename T>
size_t resident_smem_bytes(int NHP, int W) {
  return ((size_t)2 * NHP * (W + 2 * HALO_MAIN) +
          (size_t)2 * NHP * (W + 2 * HALO_HALF) +
          (size_t)(XS_STAGE + 1) * XS_LANES) * sizeof(T);
}

// threads of a block with bands of W columns: W / 32 warps across the
// band times 32 / (W / 32) row groups
int resident_threads(int W) {
  const int cw = W / BAND_ALIGN;
  return BAND_ALIGN * cw * (RESIDENT_BLOCK / BAND_ALIGN / cw);
}

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

// What a thread of the resident form owns: band-local column j (global
// column m) in rows r0, r0 + RW, ... of a band of Wb columns, the
// column's terms, and where it publishes its a_hs, b_hs (the offset of
// its column in the band's exchange slot, or -1: only the band's first
// two and last two columns publish).
template <typename T>
struct Lane {
  int r0, RW, j, m, pub;
  bool live, ghost_col, edge_col;
  T ph, colf_main, colf_half;
};

// One cell's stencil in shared memory: the pair it advances (dA, dB) at
// offset od, the other pair (nA, nB, row stride Sn) at offset on, which is
// the cell's column in row n.  INTERIOR: rows 2 <= n < N, where the row
// terms are constants, n±1 never wrap and nf (= n) comes from the caller;
// else every term as half_step_cell computes it, the row wrap included.
// The same operands in the same order as half_step_cell, so the same bits.
template <typename T, bool INTERIOR>
__device__ __forceinline__ void band_cell(
    const T* __restrict__ dA, const T* __restrict__ dB,
    const T* __restrict__ nA, const T* __restrict__ nB, int od, int on,
    int Sn, int n, int NHP, int N, T nf, T cp_t, T cp_t1, T colf, T a0v,
    const Params<T>& p, T& a_src, T& b_src, T& a_new, T& b_new) {
  int up = Sn, dn = -Sn;
  T n_ge2 = T(1), w_n = T(1), nu_a = p.nu, nu_b = p.nu;
  if (!INTERIOR) {
    const bool row_live = n < N;
    up = n + 1 == NHP ? -n * Sn : Sn;
    dn = n == 0 ? (NHP - 1) * Sn : -Sn;
    nf = row_live ? T(n) : T(0);
    n_ge2 = n >= 2 ? T(1) : T(0);
    w_n = n == 0 ? T(0) : (n == 1 ? T(2) : T(1));
    nu_a = p.nu * (row_live ? T(1) : T(0));
    nu_b = nu_a * (n > 0 ? T(1) : T(0));
  }
  const T dmb_p = nB[on + up + 1] - nB[on + up - 1];
  const T dmb_m = nB[on + dn + 1] - nB[on + dn - 1];
  const T dma_p = nA[on + up + 1] - nA[on + up - 1];
  const T dma_m = nA[on + dn + 1] - nA[on + dn - 1];
  a_src = dA[od];
  b_src = dB[od];
  slb::cell_update(a_src, b_src, dmb_p, dmb_m, dma_p, dma_m, a0v, nf * cp_t,
                   nf * cp_t1, nu_a, nu_b, n_ge2, w_n, colf, p, a_new, b_new);
}

// The thread's cell in row n: band_cell, then (MAIN) the ghost fill --
// a0_ghost is 0 in the interior (models/superlattice.py), so the fill adds
// gf · 0 there, as the plain version does -- or (half grid) the edge swap
// at column M+1 and the publication of the band's edge columns.  dst is
// updated in place: a cell reads dst only at its own (n, m), every
// neighbour from the other pair, which no thread writes in this phase.
template <typename T, bool MAIN, bool INTERIOR>
__device__ __forceinline__ void own_cell(
    T* __restrict__ dA, T* __restrict__ dB, const T* __restrict__ nA,
    const T* __restrict__ nB, int od, int on, int Sn, int n, T nf, int gi,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost,
    T* __restrict__ edge_a, T* __restrict__ edge_b, T* __restrict__ pub,
    T cp_t, T cp_t1, T colf, T gf, const Params<T>& p, const Geometry& g,
    const Lane<T>& L) {
  T a_src, b_src, a_new, b_new;
  band_cell<T, INTERIOR>(dA, dB, nA, nB, od, on, Sn, n, g.NHP, g.N, nf, cp_t,
                         cp_t1, colf, __ldg(a0 + gi), p, a_src, b_src, a_new,
                         b_new);
  if (MAIN) {
    const bool ghost = L.ghost_col || (!INTERIOR && n >= g.N);
    a_new = a_new + gf * (ghost ? __ldg(a0_ghost + gi) : T(0));
  } else if (L.edge_col) {
    a_new = edge_a[n];
    b_new = edge_b[n];
    edge_a[n] = a_src;
    edge_b[n] = b_src;
  }
  dA[od] = a_new;
  dB[od] = b_new;
  if (!MAIN && pub != nullptr) {
    __stcg(pub + n, a_new);
    __stcg(pub + g.NHP + n, b_new);
  }
}

// One half-step over the thread's cells of the band (MAIN: the main grid,
// dst a, b and nb a_hs, b_hs; else the half grid, the other way round);
// Sd, hd and Sn, hn: the row stride and halo width of the dst and nb pair.
// Rows 0 and 1 and rows >= N take the general cell, the rest the interior
// one; a thread's rows ascend, so these are three runs.
template <typename T, bool MAIN>
__device__ __forceinline__ void band_half_step(
    T* dA, T* dB, const T* nA, const T* nB, int Sd, int hd, int Sn, int hn,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost, T* edge_a,
    T* edge_b, T* pub, T cp_t, T cp_t1, T colf, T gf, const Params<T>& p,
    const Geometry& g, const Lane<T>& L) {
  if (!L.live) return;
  const int RW = L.RW, dd = RW * Sd, dnb = RW * Sn, dg = RW * g.MP;
  int n = L.r0;
  int od = n * Sd + L.j + hd, on = n * Sn + L.j + hn, gi = n * g.MP + L.m;
  if (n < 2) {
    own_cell<T, MAIN, false>(dA, dB, nA, nB, od, on, Sn, n, T(0), gi, a0,
                             a0_ghost, edge_a, edge_b, pub, cp_t, cp_t1,
                             colf, gf, p, g, L);
    n += RW;
    od += dd;
    on += dnb;
    gi += dg;
  }
  T nf = T(n);
  for (; n < g.N; n += RW, od += dd, on += dnb, gi += dg, nf += T(RW))
    own_cell<T, MAIN, true>(dA, dB, nA, nB, od, on, Sn, n, nf, gi, a0,
                            a0_ghost, edge_a, edge_b, pub, cp_t, cp_t1, colf,
                            gf, p, g, L);
  for (; n < g.NHP; n += RW, od += dd, on += dnb, gi += dg)
    own_cell<T, MAIN, false>(dA, dB, nA, nB, od, on, Sn, n, T(0), gi, a0,
                             a0_ghost, edge_a, edge_b, pub, cp_t, cp_t1,
                             colf, gf, p, g, L);
}

// The main half-step on the band's two a, b halo columns (local -1 and
// Wb, global c0 - 1 and c0 + Wb with the column wrap), which the
// neighbours compute as their own: the same inputs (a_hs, b_hs two
// columns deep), so the same bits, and no exchange of a, b.
template <typename T>
__device__ __forceinline__ void halo_cells(
    T* sA, T* sB, const T* sAh, const T* sBh, int SA, int SH, int c0, int Wb,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost,
    const T* __restrict__ phi, T cos_t, T cos_t_dt, T gf, const Params<T>& p,
    const Geometry& g) {
  const int NHP = g.NHP, MP = g.MP;
  for (int k = threadIdx.x; k < 2 * NHP; k += blockDim.x) {
    const bool right = k >= NHP;
    const int n = right ? k - NHP : k;
    const int c = right ? Wb : -1;
    int col = c0 + c;
    col = col < 0 ? col + MP : (col >= MP ? col - MP : col);
    const T ph = __ldg(phi + col);
    const int gi = n * MP + col;
    const int od = n * SA + c + HALO_MAIN;
    T a_src, b_src, a_new, b_new;
    band_cell<T, false>(sA, sB, sAh, sBh, od, n * SH + c + HALO_HALF, SH, n,
                        NHP, g.N, T(0),
                        (p.E_dc + p.E_omega * cos_t + p.B * ph) * p.dt / T(2),
                        (p.E_dc + p.E_omega * cos_t_dt + p.B * ph) * p.dt /
                            T(2),
                        (col >= 1 && col <= g.M + 1) ? T(1) : T(0),
                        __ldg(a0 + gi), p, a_src, b_src, a_new, b_new);
    const bool ghost = col == 0 || col >= g.M + 2 || n >= g.N;
    a_new = a_new + gf * (ghost ? __ldg(a0_ghost + gi) : T(0));
    sA[od] = a_new;
    sB[od] = b_new;
  }
}

// The a_hs, b_hs halo columns from the neighbours' published edge
// columns: local -2, -1 from the left band's last two, Wb, Wb + 1 from the
// right band's first two.  x is the step's exchange parity: bands x
// XCH_LANES x NHP values, lane q = (side · 2 + which) · 2 + array of the
// publishing band.  Read past L1 (other SMs wrote them).
template <typename T>
__device__ __forceinline__ void fill_halo(T* sAh, T* sBh, const T* x,
                                          int left, int right, int NHP,
                                          int SH, int Wb) {
  const size_t slot = (size_t)XCH_LANES * NHP;
  for (int k = threadIdx.x; k < XCH_LANES * NHP; k += blockDim.x) {
    const int q = k / NHP, n = k - q * NHP;
    const int arr = q & 1, which = (q >> 1) & 1, side = q >> 2;
    const int c = side ? which - 2 : Wb + which;
    const T v = __ldcg(x + (side ? left : right) * slot + k);
    (arr ? sBh : sAh)[n * SH + c + HALO_HALF] = v;
  }
}

// Rows 0 and 1 of the band's new a, b, weighted, summed over the warp's
// 32 columns into sums[row][column group]: row 0 norm (a·w_av) and v_y
// (a·w_av_phi), row 1 v_dr (b·w_av) and m_x (a·w_av).  Each thread reads
// the cell it wrote itself.  Warp-uniform: the warps of row groups 0, 1.
template <typename T>
__device__ __forceinline__ void row_sums(T (&sums)[2][SUM_WARPS][2],
                                         const T* sA, const T* sB, int SA,
                                         const T* __restrict__ w_av,
                                         const T* __restrict__ w_av_phi,
                                         const Lane<T>& L) {
  if (L.r0 >= 2) return;
  T x = T(0), y = T(0);
  if (L.live) {
    const int o = L.r0 * SA + L.j + HALO_MAIN;
    const T w = __ldg(w_av + L.m);
    if (L.r0 == 0) {
      x = sA[o] * w;
      y = sA[o] * __ldg(w_av_phi + L.m);
    } else {
      x = sB[o] * w;
      y = sA[o] * w;
    }
  }
  x = slb::warp_sum(x);
  y = slb::warp_sum(y);
  if ((threadIdx.x & 31) == 0) {
    sums[L.r0][L.j >> 5][0] = x;
    sums[L.r0][L.j >> 5][1] = y;
  }
}

// The band's partials from the warps' sums, in column-group order, to its
// slot of part (thread 0, after a block barrier).
template <typename T>
__device__ __forceinline__ void band_partials(T (&sums)[2][SUM_WARPS][2],
                                              int cw, T* part) {
  T s[PART_LANES] = {T(0), T(0), T(0), T(0)};
  for (int c = 0; c < cw; ++c) {
    s[0] += sums[0][c][0];   // norm
    s[1] += sums[1][c][0];   // v_dr
    s[2] += sums[0][c][1];   // v_y
    s[3] += sums[1][c][1];   // m_x
  }
  for (int q = 0; q < PART_LANES; ++q) __stcg(part + q, s[q]);
}

// Every band's partials added in a fixed order by one warp: lane l the
// bands l, l+32, ... in order, then warp_sum's shuffle tree.  The totals
// are valid in lane 0.
template <typename T>
__device__ __forceinline__ void total_sums(const T* part, int nb,
                                           T (&tot)[PART_LANES]) {
  T s[PART_LANES] = {T(0), T(0), T(0), T(0)};
  for (int k = threadIdx.x & 31; k < nb; k += 32)
    for (int q = 0; q < PART_LANES; ++q)
      s[q] += __ldcg(part + (size_t)k * PART_LANES + q);
  for (int q = 0; q < PART_LANES; ++q) tot[q] = slb::warp_sum(s[q]);
}

// A step's av update and display-77 record from every band's partials of
// its new a, b, by the head warp: total_sums, then in lane 0 the av chain
// (flags bit 1), the record (bit 2: the pre-step sums in carry, the loop
// t, the post-step av) and the carry for the next step's record (bit 0:
// the partials were written).  pend: the step's cos_av, sin_av, loop t
// and record slot.
template <typename T>
__device__ __forceinline__ void finish_step(T (&r)[8], T (&carry)[PART_LANES],
                                            const T* part, int nb,
                                            const T* pend, int flags, T dt,
                                            T* obs) {
  T tot[PART_LANES] = {T(0), T(0), T(0), T(0)};
  if (flags & 1) total_sums(part, nb, tot);
  if ((threadIdx.x & 31) != 0) return;
  if (flags & 2) slb::av_chain(r, tot[1], tot[2], tot[3], pend[0], pend[1], dt);
  if (flags & 4) {
    T* rec = obs + (size_t)pend[3] * OBS_LANES;
    for (int q = 0; q < PART_LANES; ++q) rec[q] = carry[q];
    rec[4] = pend[2];
    for (int q = 0; q < 8; ++q) rec[5 + q] = r[q];
  }
  if (flags & 1)
    for (int q = 0; q < PART_LANES; ++q) carry[q] = tot[q];
}

// The resident form: block k of gridDim.x bands holds band k for the
// whole chunk (see the file's notes).  Shared memory: a, b with HALO_MAIN
// columns each side (row stride SA), a_hs, b_hs with HALO_HALF (SH), then
// XS_STAGE + 1 rows of the xs table.  xch holds 2 step parities x bands x
// XCH_LANES x NHP values, part 2 step parities x bands x PART_LANES.  The
// state arrays carry no __restrict__: they are read at the start and
// written at the end.
//
// A step: phase A, the main half-step on the band and its a, b halo
// columns (meanwhile the head warp, block 0's last, adds the previous
// step's partials: finish_step); the row sums; a block barrier; phase B,
// the half-grid half-step on the band, publishing its edge columns of
// a_hs, b_hs to xch[i % 2]; ONE grid barrier; the a_hs, b_hs halo from
// the neighbours; a block barrier.  Both buffers are double-buffered by
// step parity: a band writes parity (i + 1) % 2 in step i + 1 only after
// the grid barrier of step i, which every reader of that parity's step
// i - 1 values crossed after reading them (the head reads step i - 1's
// partials before its block reaches the grid barrier of step i).  The
// head warp is the last: its row group has as few rows as any, so the
// adding does not hold up the main half-step.
template <typename T>
__global__ void __launch_bounds__(RESIDENT_BLOCK, 1)
    resident_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
                   const T* __restrict__ a0, const T* __restrict__ a0_ghost,
                   const T* __restrict__ phi, const T* __restrict__ w_av,
                   const T* __restrict__ w_av_phi, const T* __restrict__ xs,
                   T* obs, T* xch, T* part, Params<T> p, Geometry g, int W,
                   int n_steps, int parity0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T sums[2][SUM_WARPS][2];
  __shared__ T pend[4];    // the head's pending step (finish_step)
  __shared__ int pflags;
  cg::grid_group grid = cg::this_grid();
  const int NHP = g.NHP, MP = g.MP;
  const int band = blockIdx.x, nb = gridDim.x;
  const int c0 = band * W;
  const int Wb = min(W, MP - c0);
  const int SA = W + 2 * HALO_MAIN, SH = W + 2 * HALO_HALF;
  T* const sA = reinterpret_cast<T*>(smem_raw);
  T* const sB = sA + NHP * SA;
  T* const sAh = sB + NHP * SA;
  T* const sBh = sAh + NHP * SH;
  T* const sX = sBh + NHP * SH;
  const int warp = threadIdx.x >> 5;
  const int cw = W / BAND_ALIGN;

  Lane<T> L;
  L.RW = (blockDim.x >> 5) / cw;
  L.j = (warp % cw) * BAND_ALIGN + (threadIdx.x & 31);
  L.r0 = warp / cw;
  L.live = L.j < Wb;
  L.m = c0 + L.j;
  L.ghost_col = L.m == 0 || L.m >= g.M + 2;
  L.edge_col = L.live && L.m == g.M + 1;
  L.ph = L.live ? phi[L.m] : T(0);
  L.colf_main = (L.live && L.m >= 1 && L.m <= g.M + 1) ? T(1) : T(0);
  L.colf_half = (L.live && L.m >= 1 && L.m <= g.M) ? T(1) : T(0);
  L.pub = -1;
  if (L.live && (L.j < 2 || L.j >= Wb - 2)) {
    const int side = L.j < 2 ? 0 : 1;
    const int which = side ? L.j - (Wb - 2) : L.j;
    L.pub = (side * 2 + which) * 2 * NHP;
  }
  const int left = band == 0 ? nb - 1 : band - 1;
  const int right = band + 1 == nb ? 0 : band + 1;
  const size_t slot = (size_t)XCH_LANES * NHP;

  // the band and its halo columns (the column wrap of the plain version)
  for (int k = threadIdx.x; k < NHP * (Wb + 2 * HALO_MAIN); k += blockDim.x) {
    const int n = k / (Wb + 2 * HALO_MAIN), jj = k - n * (Wb + 2 * HALO_MAIN);
    int col = c0 - HALO_MAIN + jj;
    col = col < 0 ? col + MP : (col >= MP ? col - MP : col);
    sA[n * SA + jj] = a[n * MP + col];
    sB[n * SA + jj] = b[n * MP + col];
  }
  for (int k = threadIdx.x; k < NHP * (Wb + 2 * HALO_HALF); k += blockDim.x) {
    const int n = k / (Wb + 2 * HALO_HALF), jj = k - n * (Wb + 2 * HALO_HALF);
    int col = c0 - HALO_HALF + jj;
    col = col < 0 ? col + MP : (col >= MP ? col - MP : col);
    sAh[n * SH + jj] = a_hs[n * MP + col];
    sBh[n * SH + jj] = b_hs[n * MP + col];
  }
  // adds the partials: block 0's last warp; av in its lane 0
  const bool head = band == 0 && warp == (int)(blockDim.x >> 5) - 1;
  const bool head0 = head && (threadIdx.x & 31) == 0;
  T r[8] = {};
  T carry[PART_LANES] = {T(0), T(0), T(0), T(0)};   // pre-step sums
  if (head0)
    for (int q = 0; q < 8; ++q) r[q] = av[q];
  __syncthreads();

  if (xs[8] > T(0)) {   // the first step's record needs its pre-step sums
    // (step -1's: parity 1)
    row_sums(sums, sA, sB, SA, w_av, w_av_phi, L);
    __syncthreads();
    if (threadIdx.x == 0)
      band_partials(sums, cw, part + (size_t)(nb + band) * PART_LANES);
    grid.sync();
    if (head) {
      T tot[PART_LANES];
      total_sums(part + (size_t)nb * PART_LANES, nb, tot);
      for (int q = 0; q < PART_LANES; ++q) carry[q] = tot[q];
    }
  }

  for (int i = 0; i < n_steps; ++i) {
    if (i % XS_STAGE == 0) {   // the next XS_STAGE + 1 rows of the table
      const int rows = min(XS_STAGE + 1, n_steps - i);
      for (int k = threadIdx.x; k < rows * XS_LANES; k += blockDim.x)
        sX[k] = xs[(size_t)i * XS_LANES + k];
      __syncthreads();
    }
    const T* row = sX + (i % XS_STAGE) * XS_LANES;
    const T gf = ((i + parity0 + 1) % 2 == 0) ? T(1) : T(0);
    const bool do_av = row[6] > T(0);
    const bool emit = row[8] > T(0);
    // this step's sums serve its av and the next step's record
    const bool need = do_av || (i + 1 < n_steps && row[XS_LANES + 8] > T(0));
    const size_t par = i & 1;

    // phase A: the main grid on the band and its a, b halo columns, then
    // the row sums of the new a, b; the head finishes the previous step
    if (head) {
      if (i > 0)
        finish_step(r, carry, part + (1 - par) * nb * PART_LANES, nb, pend,
                    pflags, p.dt, obs);
      __syncwarp();
      if (head0) {
        pend[0] = row[4];
        pend[1] = row[5];
        pend[2] = row[7];
        pend[3] = row[9];
        pflags = (need ? 1 : 0) | (do_av ? 2 : 0) | (emit ? 4 : 0);
      }
      __syncwarp();
    }
    halo_cells(sA, sB, sAh, sBh, SA, SH, c0, Wb, a0, a0_ghost, phi, row[0],
               row[1], gf, p, g);
    band_half_step<T, true>(
        sA, sB, sAh, sBh, SA, HALO_MAIN, SH, HALO_HALF, a0, a0_ghost,
        nullptr, nullptr, nullptr,
        (p.E_dc + p.E_omega * row[0] + p.B * L.ph) * p.dt / T(2),
        (p.E_dc + p.E_omega * row[1] + p.B * L.ph) * p.dt / T(2),
        L.colf_main, gf, p, g, L);
    if (need) row_sums(sums, sA, sB, SA, w_av, w_av_phi, L);
    __syncthreads();
    if (need && threadIdx.x == 0)
      band_partials(sums, cw, part + (par * nb + band) * PART_LANES);

    // phase B: the half grid against the new a, b; its edge columns out
    band_half_step<T, false>(
        sAh, sBh, sA, sB, SH, HALO_HALF, SA, HALO_MAIN, a0, a0_ghost, edge_a,
        edge_b, L.pub < 0 ? nullptr : xch + (par * nb + band) * slot + L.pub,
        (p.E_dc + p.E_omega * row[2] + p.B * L.ph) * p.dt / T(2),
        (p.E_dc + p.E_omega * row[3] + p.B * L.ph) * p.dt / T(2),
        L.colf_half, T(0), p, g, L);
    grid.sync();
    fill_halo(sAh, sBh, xch + par * nb * slot, left, right, NHP, SH, Wb);
    __syncthreads();
  }
  if (head)   // the last step's av and record
    finish_step(r, carry, part + (size_t)((n_steps - 1) & 1) * nb * PART_LANES,
                nb, pend, pflags, p.dt, obs);

  for (int k = threadIdx.x; k < NHP * Wb; k += blockDim.x) {
    const int n = k / Wb, jj = k - n * Wb;
    const int gi = n * MP + c0 + jj;
    a[gi] = sA[n * SA + jj + HALO_MAIN];
    b[gi] = sB[n * SA + jj + HALO_MAIN];
    a_hs[gi] = sAh[n * SH + jj + HALO_HALF];
    b_hs[gi] = sBh[n * SH + jj + HALO_HALF];
  }
  if (head0)
    for (int q = 0; q < 8; ++q) av[q] = r[q];
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
                 const T* xs, T* obs, T* xch, T* part, int N, int M, int NHP,
                 int MP, int W, int n_steps, int parity0, void* stream) {
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
                  &xs,  &obs,      &xch,    &part, &p,        &g,
                  &W,   &n_steps,  &parity0};
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
// buffer xch (2 x bands x 4 x NHP values) and the partials part (bands x
// 4), both device scratch, and the band width W.  They enqueue ONE
// cooperative launch of ceil(MP / W) blocks on `stream`, do not
// synchronise, and return 0, the cudaError_t of a refused launch
// (cudaErrorInvalidValue for bands that cannot hold the state), or
// NOT_CO_RESIDENT; a refused launch changes nothing.
template <typename T>
int resident_entry(void* a, void* b, void* a_hs, void* b_hs, void* edge_a,
                   void* edge_b, void* av, const void* a0,
                   const void* a0_ghost, const void* phi, const void* w_av,
                   const void* w_av_phi, const void* params, const void* xs,
                   void* obs, void* xch, void* part, int N, int M, int NHP,
                   int MP, int W, int n_steps, int parity0, void* stream) {
  return run_resident<T>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      (const T*)a0, (const T*)a0_ghost, (const T*)phi, (const T*)w_av,
      (const T*)w_av_phi, (const T*)params, (const T*)xs, (T*)obs, (T*)xch,
      (T*)part, N, M, NHP, MP, W, n_steps, parity0, stream);
}

extern "C" int slb_resident_chunk_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* params,
    const void* xs, void* obs, void* xch, void* part, int N, int M, int NHP,
    int MP, int W, int n_steps, int parity0, void* stream) {
  return resident_entry<float>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                               a0_ghost, phi, w_av, w_av_phi, params, xs,
                               obs, xch, part, N, M, NHP, MP, W, n_steps,
                               parity0, stream);
}

extern "C" int slb_resident_chunk_f64(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* params,
    const void* xs, void* obs, void* xch, void* part, int N, int M, int NHP,
    int MP, int W, int n_steps, int parity0, void* stream) {
  return resident_entry<double>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                                a0_ghost, phi, w_av, w_av_phi, params, xs,
                                obs, xch, part, N, M, NHP, MP, W, n_steps,
                                parity0, stream);
}

// resident_info for float or double; returns 0 or the cudaError_t of the
// query (cudaErrorInvalidValue for bands that cannot hold the state)
extern "C" int slb_resident_info(int f64, int W, int NHP, int MP, int* out) {
  return f64 ? resident_info<double>(W, NHP, MP, out)
             : resident_info<float>(W, NHP, MP, out);
}
