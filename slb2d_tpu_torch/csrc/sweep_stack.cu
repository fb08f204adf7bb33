// A chunk of full steps for a whole batch of sweep points on an NVIDIA
// Hopper card (sm_90a), float and double.
//
// Replaces the Pallas TPU kernel slb2d_tpu/ops/sweep_stack.py:_kernel
// (kernel B3) in both of its modes.  For every point p and every step i
// of a chunk it computes what B3 computes:
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
//   5. p's Kahan-compensated av() update, gated by xs lane 6 (the time
//      window, to the longest point's end) AND p's egate (E_omega > 0):
//      a dc-only point's av stays exactly zero.
//
// Shared-omega mode (PER_OMEGA = false; B3 with per_omega=False): the
// trig of every step comes from the chunk's exact host table (xs lanes
// 0-5), shared by all points.
//
// Per-omega mode (PER_OMEGA = true; B3 with per_omega=True, omega swept):
//   - trig from p's angle-addition chains (cos wt, sin wt, cos w(t+dt/2),
//     sin w(t+dt/2)), advanced each step by p's cos(w dt), sin(w dt)
//     (host f64, rounded to T) and re-evaluated exactly, cos/sin of
//     w * xs[i, 7] and w * (xs[i, 7] + dt/2) in T, at every step i of the
//     chunk with i % TRIG_RESYNC == 0, as B3's resync-block loop does
//     (sweep_stack.py:286-318).  The chains are uniform per point: each
//     thread carries them in registers;
//   - p's averaging window ends at its own t_end: av also needs
//     xs[i, 7] < t_end_p (sweep_stack.py:219-222);
//   - the display-4 loop-exit capture fires in the kernel at the one step
//     with t_i < t_end_p <= t_i + dt (in T, from the table's t): four
//     block sums of the new arrays (b[1]·w_d4, a[0]·w_d4_phi, a[1]·w_d4,
//     a[0]·w_av) go to p's row of the (B, 4) capture array, which is
//     carried in and out of every launch; a point already past its exit
//     keeps its incoming values (sweep_stack.py:247-271).  With frames
//     (cap_a, cap_b not null) the same step also copies p's new a, b
//     into its (NHP, MP) slices of cap_a, cap_b, as the JAX package's
//     vmapped engine freezes them (slb2d_tpu/parallel/sweep.py:42-86);
//     B3 has no such capture and JAX routes frames of an omega sweep
//     to its vmapped engine.
//   Where this differs from B3: both half-steps' mu are computed fresh
//   from the step's chain values, as stepper.cu computes them.  B3 carries
//   the main grid's mu_t from the previous step's recurrence cos_t_dt
//   into a resync step instead of rebuilding it from the fresh exact
//   cos_t (sweep_stack.py:172, :294), so at every resync step the two
//   main-grid mu_t differ by the chain drift (~8e-6 relative at most,
//   docs/PERF.md "Per-omega drift at paper scale").  B3 is float-only;
//   this kernel also runs in double.
//
// Design: sweep points are independent, and B3 keeps a point group
// resident in VMEM for a whole chunk.  Two forms here, one launch per
// chunk each; ops/sweep_stack_cuda.py:cluster_plan picks the form:
//
//   Cluster form (sweep_cluster): a thread-block cluster of CS blocks
//   (CS in 1, 2, 4, 8, the portable sizes) owns one point for the whole
//   chunk.  Rank r holds rows [r·R, (r+1)·R), R = NHP / CS >= 2, of a, b,
//   a_hs, b_hs and its rows' carried edges in dynamic shared memory:
//   (SLAB_ARRAYS·R·MP + EDGE_ARRAYS·R)·sizeof(T) bytes, which with the
//   block sums' static scratch must fit SMEM_LIMIT.  The state crosses
//   device memory twice per chunk: loaded at its start, written back at
//   its end (and at p's exit step for frames).  A cell's neighbours at
//   n±1 in the rank's own rows are read in its shared memory; a rank's
//   first and last rows read the adjacent rank's last and first rows in
//   place through distributed shared memory (map_shared_rank), with the
//   row wrap of the plain version (row 0 reads row NHP-1 of the last
//   rank, row NHP-1 row 0 of rank 0).  cluster.sync() takes the place of
//   the two block barriers of a step:
//     - phase A, the main half-step, writes a, b in place and reads only
//       a_hs, b_hs as neighbours;
//     - cluster barrier;
//     - phase B, the half-grid half-step, writes a_hs, b_hs in place and
//       reads the new a, b as neighbours; the av and capture sums read
//       rows 0 and 1 of the new a, b (rank 0's, as R >= 2), which phase B
//       does not write, so rank 0 runs them in the same phase;
//     - cluster barrier: the next step's phase A reads a_hs, b_hs at n±1
//       and overwrites the a, b the sums read.  The last step's barrier
//       is also the one before exit: after it no rank reads another's
//       shared memory, so none leaves while another still reads it.
//   a0, a0_ghost, phi, the weights and the xs table stay in device memory
//   and are read through the read-only path (a0 and a0_ghost, 2 × 98 KB
//   in float at N=40 M=500, stay in L2).
//
//   Streaming form (sweep_chunk): ONE block owns one point, its state in
//   device memory, __syncthreads() as the two barriers; every step walks
//   ~10 array passes of the point through L2 from one SM.  It serves
//   points no portable cluster holds (e.g. N=100 M=4000: 6.8 MB a point),
//   as the JAX package bounds its kernel by fits_vmem_point
//   (sweep_stack.py:87-92) but, unlike it, keeps such sweeps on a kernel.
//
// Both forms compute every cell of the (NHP, MP) arrays, pad cells
// included, with half_step.cuh's operand order, and reduce the sums in the
// same block order, so they agree bit for bit in the state and in av.
// B3's "columnar" av (every stacked row carries its own chain) is a VMEM
// layout trick; a per-point block reduction of the sums computes the same
// observables, and thread 0 keeps p's av in registers across the chunk.
//
// What bounds it on the H100: the least time for the work is its
// arithmetic, 28 adds, multiplies and divisions per live cell of a
// half-step at 33.5 T per second, an H100's f32 rate without FMA
// (chip_smoke.py main_path_flops, PERF.md §6).  The streaming form is
// bound by one SM's walk of its point through L2 per step (4% of that at
// 64 and 256 points).  The cluster form removes the walk; what bounds it
// is each SM's work on its R·MP cells (the arithmetic with the IEEE
// division, the index arithmetic, the shared and read-only loads), and
// the waves of clusters: at CS=2 one block per SM (196,800 B in float at
// N=40 M=500) gives 66 points at a time, so the 256-point paper map runs
// in four waves of whole chunks.  On an H100 80GB HBM3 at 700 W a wave
// took ~22.3 µs a step in float (12,288 cells an SM) and ~16.2 in double
// (CS=4, 6,144 cells an SM): its time follows the cells an SM updates,
// not the two cluster barriers (PERF.md §5).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "half_step.cuh"

namespace cg = cooperative_groups;

namespace {

using slb::Geometry;
using slb::Params;
using slb::XS_LANES;

constexpr int SWEEP_BLOCK = 1024;

// per-point columns (lane order: slb2d_tpu_torch/ops/sweep_stack_cuda.py
// PP_*, which tests/test_torch_sweep_omega.py holds to these)
constexpr int PP_COLS = 12;
constexpr int PP_EDC = 0, PP_EOM = 1, PP_B = 2, PP_BDT = 3, PP_EGATE = 4,
              PP_OMEGA = 5, PP_TEND = 6, PP_CDT = 7, PP_SDT = 8;

// the per-omega chains are re-evaluated exactly every TRIG_RESYNC steps
// of a chunk (slb2d_tpu/ops/sweep_stack.py TRIG_RESYNC)
constexpr int TRIG_RESYNC = 32;

// capture columns (sweep_stack_cuda.py CAP_KEYS order)
constexpr int CAP_COLS = 4;

// The cluster form's shared-memory budget (sweep_stack_cuda.py
// cluster_plan mirrors these; tests/test_torch_sweep_cluster.py holds the
// two to each other): a block's opt-in shared memory on an H100, the
// largest portable cluster, a rank's slab arrays and edge arrays, and the
// static scratch of block_sums<T, 3> and block_sums<T, CAP_COLS>
// (elements).
constexpr int SMEM_LIMIT = 232448;
constexpr int CLUSTER_MAX = 8;
constexpr int SLAB_ARRAYS = 4;
constexpr int EDGE_ARRAYS = 2;
constexpr int SUM_SCRATCH = 224;

// returned when no cluster of the launch fits on the card at once
constexpr int NO_ACTIVE_CLUSTER = -1;

template <typename T>
size_t cluster_smem_bytes(int R, int MP) {
  return ((size_t)SLAB_ARRAYS * R * MP + (size_t)EDGE_ARRAYS * R) * sizeof(T);
}

// scalars every point shares (sweep_stack_cuda.py SCALAR_FIELDS order)
template <typename T>
struct Shared {
  T dt, nu, nu2, nu_tilde;
};

// The state arrays carry no __restrict__: each is written in one phase
// and read by other threads in the next, so none may be read through the
// read-only cache path.  cap, w_d4 and w_d4_phi are used only in
// per-omega mode (null otherwise); cap_a, cap_b only there and only with
// frames (null otherwise).
template <typename T, bool PER_OMEGA>
__global__ void __launch_bounds__(SWEEP_BLOCK)
    sweep_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
                T* cap, T* cap_a, T* cap_b, const T* __restrict__ a0,
                const T* __restrict__ a0_ghost, size_t a0_stride,
                const T* __restrict__ phi, const T* __restrict__ w_av,
                const T* __restrict__ w_av_phi, const T* __restrict__ w_d4,
                const T* __restrict__ w_d4_phi, const T* __restrict__ pp,
                Shared<T> s, const T* __restrict__ xs, Geometry g,
                int n_steps, int parity0) {
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

  // per-omega: p's frequency, window end, chain increments and chains
  T om = T(0), t_end = T(0), cdt = T(0), sdt = T(0);
  T ct = T(0), st = T(0), chs = T(0), shs = T(0);
  if (PER_OMEGA) {
    om = q[PP_OMEGA];
    t_end = q[PP_TEND];
    cdt = q[PP_CDT];
    sdt = q[PP_SDT];
  }

  T r[8] = {};   // p's av, live in thread 0 only
  if (threadIdx.x == 0)
    for (int j = 0; j < 8; ++j) r[j] = av_p[j];

  for (int i = 0; i < n_steps; ++i) {
    const T* row = xs + (size_t)i * XS_LANES;
    const T gf = ((i + parity0 + 1) % 2 == 0) ? T(1) : T(0);
    const T t_i = row[7];

    T cos_t, cos_t_dt, cos_hs, cos_hs_dt, cos_av, sin_av;
    T sin_t_dt = T(0), sin_hs_dt = T(0);
    bool do_av = egate && row[6] > T(0);
    if (PER_OMEGA) {
      if (i % TRIG_RESYNC == 0) {   // exact re-evaluation (T arithmetic)
        const T t_hs = t_i + s.dt / T(2);
        ct = cos(om * t_i);
        st = sin(om * t_i);
        chs = cos(om * t_hs);
        shs = sin(om * t_hs);
      }
      cos_t = ct;
      cos_t_dt = ct * cdt - st * sdt;
      sin_t_dt = st * cdt + ct * sdt;
      cos_hs = chs;
      cos_hs_dt = chs * cdt - shs * sdt;
      sin_hs_dt = shs * cdt + chs * sdt;
      cos_av = ct;
      sin_av = st;
      do_av = do_av && t_i < t_end;
    } else {
      cos_t = row[0];
      cos_t_dt = row[1];
      cos_hs = row[2];
      cos_hs_dt = row[3];
      cos_av = row[4];
      sin_av = row[5];
    }

    // phase A: main grid
    for (int k = threadIdx.x; k < ncell; k += SWEEP_BLOCK) {
      const int n = k / MP, m = k - n * MP;
      slb::half_step_cell<T, true>(a, b, a_hs, b_hs, a0, a0_ghost, phi,
                                   cos_t, cos_t_dt, p, g, gf, nullptr,
                                   nullptr, n, m);
    }
    __syncthreads();

    // phase B: half grid, then this point's av (and capture) sums
    for (int k = threadIdx.x; k < ncell; k += SWEEP_BLOCK) {
      const int n = k / MP, m = k - n * MP;
      slb::half_step_cell<T, false>(a_hs, b_hs, a, b, a0, a0_ghost, phi,
                                    cos_hs, cos_hs_dt, p, g, T(0), edge_a,
                                    edge_b, n, m);
    }
    if (do_av) {   // uniform across the block
      T sums[3] = {T(0), T(0), T(0)};
      for (int m = threadIdx.x; m < MP; m += SWEEP_BLOCK) {
        sums[0] += b[MP + m] * w_av[m];      // v_dr
        sums[1] += a[m] * w_av_phi[m];       // v_y
        sums[2] += a[MP + m] * w_av[m];      // m_x
      }
      slb::block_sums<T, 3>(sums);
      if (threadIdx.x == 0)
        slb::av_chain(r, sums[0], sums[1], sums[2], cos_av, sin_av, s.dt);
    }
    if (PER_OMEGA && t_i < t_end && t_i + s.dt >= t_end) {
      // p's loop exit: the display-4 inline sums of this step's arrays
      // (block_sums<T, 4> has its own scratch, apart from the av sums')
      T sums[CAP_COLS] = {T(0), T(0), T(0), T(0)};
      for (int m = threadIdx.x; m < MP; m += SWEEP_BLOCK) {
        sums[0] += b[MP + m] * w_d4[m];      // v_dr
        sums[1] += a[m] * w_d4_phi[m];       // v_y
        sums[2] += a[MP + m] * w_d4[m];      // m_x
        sums[3] += a[m] * w_av[m];           // norm (w_norm == w_av)
      }
      slb::block_sums<T, CAP_COLS>(sums);
      if (threadIdx.x == 0)
        for (int j = 0; j < CAP_COLS; ++j)
          cap[(size_t)pt * CAP_COLS + j] = sums[j];
      if (cap_a != nullptr)      // frames: p's arrays at its own exit
        for (int k = threadIdx.x; k < ncell; k += SWEEP_BLOCK) {
          cap_a[off + k] = a[k];
          cap_b[off + k] = b[k];
        }
    }
    if (PER_OMEGA) {
      ct = cos_t_dt;
      st = sin_t_dt;
      chs = cos_hs_dt;
      shs = sin_hs_dt;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0)
    for (int j = 0; j < 8; ++j) av_p[j] = r[j];
}

// One stencil application at (n, m), half_step_cell's function with the
// point's rows given by pointer: a_dst, b_dst are row n of the pair it
// updates (in place), a_up, a_dn, b_up, b_dn rows n+1 and n-1 (wrapped)
// of the other pair, a0, a0_ghost row n of the point's constants, edge_a,
// edge_b row n's carried edges.  The same masks, the same mu expressions
// and slb::cell_update, so the same bits.
template <typename T, bool MAIN>
__device__ __forceinline__ void cluster_cell(
    T* a_dst, T* b_dst, const T* a_up, const T* a_dn, const T* b_up,
    const T* b_dn, const T* a0, const T* a0_ghost, const T* phi, T cos_t,
    T cos_t_dt, const Params<T>& p, const Geometry& g, T ghost_gate,
    T* edge_a, T* edge_b, int n, int m) {
  const int MP = g.MP;
  const T nf = n < g.N ? T(n) : T(0);
  const T n_ge2 = n >= 2 ? T(1) : T(0);
  const T w_n = n == 0 ? T(0) : (n == 1 ? T(2) : T(1));
  const T nu_a = p.nu * (n < g.N ? T(1) : T(0));
  const T nu_b = nu_a * (n > 0 ? T(1) : T(0));
  const int m_hi = MAIN ? g.M + 1 : g.M;
  const T colf = (m >= 1 && m <= m_hi) ? T(1) : T(0);

  const T ph = phi[m];
  const T mu_t = nf * ((p.E_dc + p.E_omega * cos_t + p.B * ph) * p.dt / T(2));
  const T mu_t1 =
      nf * ((p.E_dc + p.E_omega * cos_t_dt + p.B * ph) * p.dt / T(2));

  const int mp1 = m + 1 == MP ? 0 : m + 1;
  const int mm1 = m == 0 ? MP - 1 : m - 1;
  const T a_src = a_dst[m];
  const T b_src = b_dst[m];
  T a_new, b_new;
  slb::cell_update(a_src, b_src, b_up[mp1] - b_up[mm1],
                   b_dn[mp1] - b_dn[mm1], a_up[mp1] - a_up[mm1],
                   a_dn[mp1] - a_dn[mm1], a0[m], mu_t, mu_t1, nu_a, nu_b,
                   n_ge2, w_n, colf, p, a_new, b_new);
  if (MAIN) {
    a_new = a_new + ghost_gate * a0_ghost[m];
  } else if (m == g.M + 1) {
    a_new = *edge_a;
    b_new = *edge_b;
    *edge_a = a_src;
    *edge_b = b_src;
  }
  a_dst[m] = a_new;
  b_dst[m] = b_new;
}

// One half-step over a rank's slab sm (a, b, a_hs, b_hs, then the edges;
// p_sm, n_sm the previous and next ranks' slabs in distributed shared
// memory).  The thread's cells are (l, m), (l, m) + SWEEP_BLOCK, ... in
// row-major order; MP is a multiple of 128, so a warp's cells share one
// row and the interior/boundary branch is uniform across it.
template <typename T, bool MAIN>
__device__ __forceinline__ void slab_half_step(
    T* sm, const T* p_sm, const T* n_sm, int slab, int R, int row0,
    const T* a0, const T* a0_ghost, const T* phi, T cos_t, T cos_t_dt,
    const Params<T>& p, const Geometry& g, T gf, int l, int m) {
  const int MP = g.MP;
  const int dl = SWEEP_BLOCK / MP, dm = SWEEP_BLOCK - dl * MP;
  const int dst = MAIN ? 0 : 2 * slab;   // a, b or a_hs, b_hs
  const int nb = MAIN ? 2 * slab : 0;    // the other pair
  T* const edges = sm + SLAB_ARRAYS * slab;
  while (l < R) {
    const int lo = l * MP;
    T* const d = sm + dst + lo;
    if (l > 0 && l + 1 < R) {            // both neighbours in this rank
      const T* const up = sm + nb + lo + MP;
      const T* const dn = sm + nb + lo - MP;
      cluster_cell<T, MAIN>(d, d + slab, up, dn, up + slab, dn + slab,
                            a0 + lo, a0_ghost + lo, phi, cos_t, cos_t_dt, p,
                            g, gf, edges + l, edges + R + l, row0 + l, m);
    } else {                             // one in the next or previous rank
      const T* const up = (l + 1 < R ? sm + lo + MP : n_sm) + nb;
      const T* const dn = (l > 0 ? sm + lo - MP : p_sm + (R - 1) * MP) + nb;
      cluster_cell<T, MAIN>(d, d + slab, up, dn, up + slab, dn + slab,
                            a0 + lo, a0_ghost + lo, phi, cos_t, cos_t_dt, p,
                            g, gf, edges + l, edges + R + l, row0 + l, m);
    }
    m += dm;
    l += dl;
    if (m >= MP) {
      m -= MP;
      ++l;
    }
  }
}

// The cluster form: a cluster of CS blocks per point (blocks pt·CS ..
// pt·CS + CS - 1), each holding R = NHP / CS rows in shared memory for the
// whole chunk.  Arguments as sweep_chunk's.
template <typename T, bool PER_OMEGA>
__global__ void __launch_bounds__(SWEEP_BLOCK)
    sweep_cluster(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
                  T* cap, T* cap_a, T* cap_b, const T* __restrict__ a0,
                  const T* __restrict__ a0_ghost, size_t a0_stride,
                  const T* __restrict__ phi, const T* __restrict__ w_av,
                  const T* __restrict__ w_av_phi,
                  const T* __restrict__ w_d4,
                  const T* __restrict__ w_d4_phi, const T* __restrict__ pp,
                  Shared<T> s, const T* __restrict__ xs, Geometry g,
                  int n_steps, int parity0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int pt = blockIdx.x / cs;
  const int MP = g.MP;
  const int R = g.NHP / cs;
  const int slab = R * MP;
  const int row0 = rank * R;
  T* const s_a = sm;
  T* const s_b = sm + slab;
  T* const s_ahs = sm + 2 * slab;
  T* const s_bhs = sm + 3 * slab;
  T* const s_edge = sm + SLAB_ARRAYS * slab;   // edge_a rows, edge_b rows

  // this rank's rows of the point in device memory
  const size_t off = (size_t)pt * g.NHP * MP + (size_t)row0 * MP;
  a += off;
  b += off;
  a_hs += off;
  b_hs += off;
  edge_a += (size_t)pt * g.NHP + row0;
  edge_b += (size_t)pt * g.NHP + row0;
  a0 += pt * a0_stride + (size_t)row0 * MP;
  a0_ghost += pt * a0_stride + (size_t)row0 * MP;
  T* av_p = av + (size_t)pt * 8;

  for (int k = threadIdx.x; k < slab; k += SWEEP_BLOCK) {
    s_a[k] = a[k];
    s_b[k] = b[k];
    s_ahs[k] = a_hs[k];
    s_bhs[k] = b_hs[k];
  }
  for (int l = threadIdx.x; l < R; l += SWEEP_BLOCK) {
    s_edge[l] = edge_a[l];
    s_edge[R + l] = edge_b[l];
  }
  // row row0 - 1 is the previous rank's last row, row row0 + R the next
  // rank's first; both wrap (rank 0's previous is the last rank)
  const T* const p_sm = cluster.map_shared_rank(sm, rank == 0 ? cs - 1
                                                              : rank - 1);
  const T* const n_sm = cluster.map_shared_rank(sm, rank + 1 == cs ? 0
                                                                   : rank + 1);

  const T* q = pp + (size_t)pt * PP_COLS;
  const Params<T> p = {q[PP_EDC], q[PP_EOM], T(0),      q[PP_B],
                       s.dt,      s.nu,      s.nu2,     s.nu_tilde,
                       q[PP_BDT], T(0),      T(0)};
  const bool egate = q[PP_EGATE] > T(0);

  T om = T(0), t_end = T(0), cdt = T(0), sdt = T(0);
  T ct = T(0), st = T(0), chs = T(0), shs = T(0);
  if (PER_OMEGA) {
    om = q[PP_OMEGA];
    t_end = q[PP_TEND];
    cdt = q[PP_CDT];
    sdt = q[PP_SDT];
  }

  T r[8] = {};   // p's av, live in rank 0's thread 0 only
  if (rank == 0 && threadIdx.x == 0)
    for (int j = 0; j < 8; ++j) r[j] = av_p[j];

  const int l0 = threadIdx.x / MP, m0 = threadIdx.x - l0 * MP;
  cluster.sync();   // every slab is loaded before a neighbour reads it

  for (int i = 0; i < n_steps; ++i) {
    const T* row = xs + (size_t)i * XS_LANES;
    const T gf = ((i + parity0 + 1) % 2 == 0) ? T(1) : T(0);
    const T t_i = row[7];

    T cos_t, cos_t_dt, cos_hs, cos_hs_dt, cos_av, sin_av;
    T sin_t_dt = T(0), sin_hs_dt = T(0);
    bool do_av = egate && row[6] > T(0);
    if (PER_OMEGA) {
      if (i % TRIG_RESYNC == 0) {
        const T t_hs = t_i + s.dt / T(2);
        ct = cos(om * t_i);
        st = sin(om * t_i);
        chs = cos(om * t_hs);
        shs = sin(om * t_hs);
      }
      cos_t = ct;
      cos_t_dt = ct * cdt - st * sdt;
      sin_t_dt = st * cdt + ct * sdt;
      cos_hs = chs;
      cos_hs_dt = chs * cdt - shs * sdt;
      sin_hs_dt = shs * cdt + chs * sdt;
      cos_av = ct;
      sin_av = st;
      do_av = do_av && t_i < t_end;
    } else {
      cos_t = row[0];
      cos_t_dt = row[1];
      cos_hs = row[2];
      cos_hs_dt = row[3];
      cos_av = row[4];
      sin_av = row[5];
    }

    // phase A: main grid
    slab_half_step<T, true>(sm, p_sm, n_sm, slab, R, row0, a0, a0_ghost,
                            phi, cos_t, cos_t_dt, p, g, gf, l0, m0);
    cluster.sync();

    // phase B: half grid, then rank 0's av (and capture) sums
    slab_half_step<T, false>(sm, p_sm, n_sm, slab, R, row0, a0, a0_ghost,
                             phi, cos_hs, cos_hs_dt, p, g, T(0), l0, m0);
    if (do_av && rank == 0) {   // uniform across the block
      T sums[3] = {T(0), T(0), T(0)};
      for (int m = threadIdx.x; m < MP; m += SWEEP_BLOCK) {
        sums[0] += s_b[MP + m] * w_av[m];      // v_dr
        sums[1] += s_a[m] * w_av_phi[m];       // v_y
        sums[2] += s_a[MP + m] * w_av[m];      // m_x
      }
      slb::block_sums<T, 3>(sums);
      if (threadIdx.x == 0)
        slb::av_chain(r, sums[0], sums[1], sums[2], cos_av, sin_av, s.dt);
    }
    if (PER_OMEGA && t_i < t_end && t_i + s.dt >= t_end) {
      if (rank == 0) {
        T sums[CAP_COLS] = {T(0), T(0), T(0), T(0)};
        for (int m = threadIdx.x; m < MP; m += SWEEP_BLOCK) {
          sums[0] += s_b[MP + m] * w_d4[m];    // v_dr
          sums[1] += s_a[m] * w_d4_phi[m];     // v_y
          sums[2] += s_a[MP + m] * w_d4[m];    // m_x
          sums[3] += s_a[m] * w_av[m];         // norm (w_norm == w_av)
        }
        slb::block_sums<T, CAP_COLS>(sums);
        if (threadIdx.x == 0)
          for (int j = 0; j < CAP_COLS; ++j)
            cap[(size_t)pt * CAP_COLS + j] = sums[j];
      }
      if (cap_a != nullptr)      // frames: this rank's rows at p's exit
        for (int k = threadIdx.x; k < slab; k += SWEEP_BLOCK) {
          cap_a[off + k] = s_a[k];
          cap_b[off + k] = s_b[k];
        }
    }
    if (PER_OMEGA) {
      ct = cos_t_dt;
      st = sin_t_dt;
      chs = cos_hs_dt;
      shs = sin_hs_dt;
    }
    cluster.sync();
  }

  for (int k = threadIdx.x; k < slab; k += SWEEP_BLOCK) {
    a[k] = s_a[k];
    b[k] = s_b[k];
    a_hs[k] = s_ahs[k];
    b_hs[k] = s_bhs[k];
  }
  for (int l = threadIdx.x; l < R; l += SWEEP_BLOCK) {
    edge_a[l] = s_edge[l];
    edge_b[l] = s_edge[R + l];
  }
  if (rank == 0 && threadIdx.x == 0)
    for (int j = 0; j < 8; ++j) av_p[j] = r[j];
}

// cudaSuccess, or why a cluster of cs blocks cannot hold an (NHP, MP)
// point: not a portable size, not >= 2 rows a rank, or past SMEM_LIMIT
template <typename T>
cudaError_t check_cluster(int cs, int NHP, int MP) {
  if (cs < 1 || cs > CLUSTER_MAX || (cs & (cs - 1)) != 0 || NHP % cs != 0 ||
      NHP / cs < 2)
    return cudaErrorInvalidValue;
  if (cluster_smem_bytes<T>(NHP / cs, MP) + SUM_SCRATCH * sizeof(T) >
      (size_t)SMEM_LIMIT)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The launch configuration of the cluster form: n_points clusters of cs
// blocks with the rank's slab as dynamic shared memory (the kernel's
// attribute set to allow it).  attr must outlive cfg.
template <typename T, bool PER_OMEGA>
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           int n_points, int cs, int NHP, int MP,
                           cudaStream_t st) {
  cudaError_t err = check_cluster<T>(cs, NHP, MP);
  if (err != cudaSuccess) return err;
  const size_t smem = cluster_smem_bytes<T>(NHP / cs, MP);
  err = cudaFuncSetAttribute(sweep_cluster<T, PER_OMEGA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(n_points * cs);
  cfg.blockDim = dim3(SWEEP_BLOCK);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, bool PER_OMEGA>
int run_sweep_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b,
                    T* av, T* cap, T* cap_a, T* cap_b, const T* a0,
                    const T* a0_ghost, const T* phi, const T* w_av,
                    const T* w_av_phi, const T* w_d4, const T* w_d4_phi,
                    const T* pp,
                    const T* params, const T* xs, int n_points,
                    int a0_batched, int N, int M, int NHP, int MP,
                    int n_steps, int parity0, int cluster_size,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shared<T> s = {params[0], params[1], params[2], params[3]};
  const Geometry g = {N, M, NHP, MP};
  const size_t a0_stride = a0_batched ? (size_t)NHP * MP : 0;
  if (cluster_size == 0) {   // the streaming form
    sweep_chunk<T, PER_OMEGA><<<n_points, SWEEP_BLOCK, 0, st>>>(
        a, b, a_hs, b_hs, edge_a, edge_b, av, cap, cap_a, cap_b, a0,
        a0_ghost, a0_stride, phi, w_av, w_av_phi, w_d4, w_d4_phi, pp, s, xs,
        g, n_steps, parity0);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T, PER_OMEGA>(cfg, attr, n_points,
                                                 cluster_size, NHP, MP, st);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, sweep_cluster<T, PER_OMEGA>,
                                       &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters == 0) return NO_ACTIVE_CLUSTER;
  err = cudaLaunchKernelEx(&cfg, sweep_cluster<T, PER_OMEGA>, a, b, a_hs,
                           b_hs, edge_a, edge_b, av, cap, cap_a, cap_b, a0,
                           a0_ghost, a0_stride, phi, w_av, w_av_phi, w_d4,
                           w_d4_phi, pp, s, xs, g, n_steps, parity0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What a form of the kernel takes on this card: out[0] registers a
// thread, out[1] bytes of local memory a thread (spills), out[2] dynamic
// shared memory a block, out[3] clusters (the streaming form: blocks)
// that run at once on the whole card.
template <typename T, bool PER_OMEGA>
int form_info(int cluster_size, int NHP, int MP, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err;
  if (cluster_size == 0) {
    err = cudaFuncGetAttributes(&fa, sweep_chunk<T, PER_OMEGA>);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sweep_chunk<T, PER_OMEGA>, SWEEP_BLOCK, 0)) !=
            cudaSuccess)
      return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = 0;
    out[3] = per_sm * sms;
    return 0;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = cluster_config<T, PER_OMEGA>(cfg, attr, 1, cluster_size, NHP, MP,
                                     nullptr);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaFuncGetAttributes(&fa, sweep_cluster<T, PER_OMEGA>)) !=
      cudaSuccess)
    return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, sweep_cluster<T, PER_OMEGA>,
                                       &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)cfg.dynamicSmemBytes;
  out[3] = clusters;
  return 0;
}

}  // namespace

// C entry points (bound with ctypes in ops/sweep_stack_cuda.py).  Every
// array pointer is a device pointer except `params` (4 host values in
// SCALAR_FIELDS order).  State arrays are (n_points, NHP, MP), edges
// (n_points, NHP), av (n_points, 8), pp (n_points, PP_COLS); a0 and
// a0_ghost are (n_points, NHP, MP) when a0_batched, else (NHP, MP).  The
// per-omega forms (slb_sweep_chunk_omega_*) also take cap (n_points, 4)
// and cap_a, cap_b (n_points, NHP, MP; both null without frames) after
// av, and w_d4, w_d4_phi (MP,) after w_av_phi.  cluster_size 0 launches
// the streaming form, 1, 2, 4 or 8 the cluster form with clusters of that
// many blocks.  They enqueue ONE launch on `stream`, do not synchronise,
// and return 0, the cudaError_t of a refused launch (cudaErrorInvalidValue
// for a cluster that cannot hold the point), or NO_ACTIVE_CLUSTER; a
// refused launch changes nothing.
template <typename T>
int shared_entry(void* a, void* b, void* a_hs, void* b_hs, void* edge_a,
                 void* edge_b, void* av, const void* a0,
                 const void* a0_ghost, const void* phi, const void* w_av,
                 const void* w_av_phi, const void* pp, const void* params,
                 const void* xs, int n_points, int a0_batched, int N, int M,
                 int NHP, int MP, int n_steps, int parity0, int cluster_size,
                 void* stream) {
  return run_sweep_chunk<T, false>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      nullptr, nullptr, nullptr, (const T*)a0, (const T*)a0_ghost,
      (const T*)phi, (const T*)w_av, (const T*)w_av_phi, nullptr, nullptr,
      (const T*)pp,
      (const T*)params, (const T*)xs, n_points, a0_batched, N, M, NHP, MP,
      n_steps, parity0, cluster_size, stream);
}

template <typename T>
int omega_entry(void* a, void* b, void* a_hs, void* b_hs, void* edge_a,
                void* edge_b, void* av, void* cap, void* cap_a, void* cap_b,
                const void* a0, const void* a0_ghost, const void* phi,
                const void* w_av, const void* w_av_phi, const void* w_d4,
                const void* w_d4_phi,
                const void* pp, const void* params, const void* xs,
                int n_points, int a0_batched, int N, int M, int NHP, int MP,
                int n_steps, int parity0, int cluster_size, void* stream) {
  return run_sweep_chunk<T, true>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      (T*)cap, (T*)cap_a, (T*)cap_b, (const T*)a0, (const T*)a0_ghost,
      (const T*)phi, (const T*)w_av, (const T*)w_av_phi, (const T*)w_d4,
      (const T*)w_d4_phi, (const T*)pp, (const T*)params, (const T*)xs,
      n_points, a0_batched, N, M, NHP, MP, n_steps, parity0, cluster_size,
      stream);
}

extern "C" int slb_sweep_chunk_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, int cluster_size,
    void* stream) {
  return shared_entry<float>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                             a0_ghost, phi, w_av, w_av_phi, pp, params, xs,
                             n_points, a0_batched, N, M, NHP, MP, n_steps,
                             parity0, cluster_size, stream);
}

extern "C" int slb_sweep_chunk_f64(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, int cluster_size,
    void* stream) {
  return shared_entry<double>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                              a0_ghost, phi, w_av, w_av_phi, pp, params, xs,
                              n_points, a0_batched, N, M, NHP, MP, n_steps,
                              parity0, cluster_size, stream);
}

extern "C" int slb_sweep_chunk_omega_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, void* cap, void* cap_a, void* cap_b, const void* a0,
    const void* a0_ghost, const void* phi, const void* w_av,
    const void* w_av_phi, const void* w_d4, const void* w_d4_phi,
    const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, int cluster_size,
    void* stream) {
  return omega_entry<float>(a, b, a_hs, b_hs, edge_a, edge_b, av, cap,
                            cap_a, cap_b, a0, a0_ghost, phi, w_av, w_av_phi,
                            w_d4, w_d4_phi, pp, params, xs, n_points,
                            a0_batched, N, M, NHP, MP, n_steps, parity0,
                            cluster_size, stream);
}

extern "C" int slb_sweep_chunk_omega_f64(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, void* cap, void* cap_a, void* cap_b, const void* a0,
    const void* a0_ghost, const void* phi, const void* w_av,
    const void* w_av_phi, const void* w_d4, const void* w_d4_phi,
    const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, int cluster_size,
    void* stream) {
  return omega_entry<double>(a, b, a_hs, b_hs, edge_a, edge_b, av, cap,
                             cap_a, cap_b, a0, a0_ghost, phi, w_av, w_av_phi,
                             w_d4, w_d4_phi, pp, params, xs, n_points,
                             a0_batched, N, M, NHP, MP, n_steps, parity0,
                             cluster_size, stream);
}

// form_info for (float or double, shared or per-omega mode); returns 0 or
// the cudaError_t of the query
extern "C" int slb_sweep_form_info(int f64, int per_omega, int cluster_size,
                                   int NHP, int MP, int* out) {
  if (f64)
    return per_omega ? form_info<double, true>(cluster_size, NHP, MP, out)
                     : form_info<double, false>(cluster_size, NHP, MP, out);
  return per_omega ? form_info<float, true>(cluster_size, NHP, MP, out)
                   : form_info<float, false>(cluster_size, NHP, MP, out);
}
