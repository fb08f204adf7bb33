// A chunk of full steps for up to CB sweep points packed along the
// columns, on an NVIDIA Hopper card (sm_90a), float.
//
// Replaces the Pallas TPU kernel slb2d_tpu/ops/sweep_pallas.py:50
// _sweep_kernel (kernel B4).  The state of a chunk is packed as (NHP,
// CB*MP): point s owns the columns [s*MP, (s+1)*MP).  The loop t starts at
// 0 and is carried as t <- fl(t + dt) (dt and t_start are not sweepable,
// so t is the same for every point).  For every step i of the run (i =
// i0 + step of the launch sequence) and every point s it computes what B4
// computes:
//   1. the main-grid half-step in the use_reciprocal form of
//      slb2d_tpu/ops/stencil.py:apply_half_step, with s's E_dc, E_omega, B
//      and bdt, and mu from cos(omega_s t) and cos(omega_s fl(t + dt));
//   2. the parity ghost fill a += gf * a0_ghost, gf = 1 on odd i;
//   3. the half-grid half-step against the new a, b, with mu from
//      cos(omega_s t_hs) and cos(omega_s fl(t_hs + dt)), t_hs =
//      fl(t + dt/2);
//   4. the edge column M+1 of s's half-step arrays takes gf times its
//      bootstrap tiptoe value (the 4-buffer rotation's stale column
//      alternates between that value and 0), kept as (CB, NHP) edge
//      vectors instead of B4's two (NHP, CB*MP) one-hot arrays;
//   5. per lane (column) the av() recurrences and the loop-exit capture:
//      live = t < t_end_s, g = live * [E_omega_s > 0] * [t >= t_start];
//      count += g; running means of b[1]*w_av, a[0]*w_av_phi, a[1]*w_av
//      over max(count, 1); Kahan sums of cos/sin(omega_s t)*x_dr*dt taken
//      where g > 0; while live, the capture rows b[1]*w_d4, a[0]*w_d4_phi,
//      a[1]*w_d4, a[0]*w_av.  The host sums each segment once after the
//      run.  Nothing here reduces across lanes, so a point's result does
//      not depend on which chunk it sits in.
// Each point's trig is the same for its whole segment and is evaluated
// with cosf/sinf (never the fast intrinsics), as torch.cos does, so the
// kernel rounds as its plain PyTorch version (slb2d_tpu_torch/ops/
// sweep_lanes_cuda.py: run_lanes_plain) does.
//
// Two forms compute that function; ops/sweep_lanes_cuda.py
// lanes_cluster_plan picks one before launching:
//
//   Cluster form (lanes_cluster, slb_lanes_cluster_f32): ONE launch per
//   call for all n_steps, as B4 keeps a chunk in VMEM for its whole
//   fori_loop.  A thread-block cluster of CS blocks (CS from 1 to 8, the
//   portable sizes, dividing NHP) owns one point of the chunk.  Rank r
//   holds rows [r*R, (r+1)*R), R = NHP / CS >= 2, of the point's a, b,
//   a_hs, b_hs in dynamic shared memory for the whole launch, with the
//   point's phi and, where they fit beside the slab, its rows of a0 and
//   a0_ghost; rank 0 also holds the point's 8 av, 4 capture and 4 weight
//   rows (its columns; rows 0-1 of the state, which they read, are rank
//   0's).  The state crosses device memory twice per launch: loaded at its
//   start, written back at its end.  Neighbours at n+-1 in the rank's own
//   rows are read in its shared memory; a rank's first and last rows read
//   the adjacent rank's last and first rows through distributed shared
//   memory (map_shared_rank), with the plain version's row wrap.  m+-1
//   wrap within the point's own MP columns: in the packed layout they
//   reach the neighbouring segment instead, but only at columns 0 and
//   MP-1, which are ghosts (MP >= M+3) that colf zeroes, so the two wraps
//   give the same values.  Two cluster.sync() a step take the place of the
//   launch boundaries:
//     - phase A, the main half-step, writes a, b in place and reads only
//       a_hs, b_hs as neighbours;
//     - cluster barrier;
//     - phase B, the half-grid half-step, writes a_hs, b_hs in place and
//       reads the new a, b; rank 0 then updates the av and capture rows of
//       each column from rows 0-1 of the new a, b, which phase B does not
//       write;
//     - cluster barrier (the next phase A reads a_hs, b_hs at n+-1 and
//       overwrites a, b).  The last step's barrier is also the one before
//       exit: after it no rank reads another's shared memory.
//   The loop t is carried in every thread as t <- fl(t + dt) from the
//   host's t0, as the streaming form's host loop carries it.  Five threads
//   of each block's last warp evaluate the next step's five trig values
//   (cos wt, cos w(t+dt), cos w t_hs, cos w(t_hs+dt), sin wt) into a
//   shared buffer double-buffered by step parity, during phase B; every
//   cell reads them there.  A thread keeps one column (or, past 1024
//   columns, a few) and walks its rows with the column's mu parts
//   computed once a phase.  Where a0 and a0_ghost do not fit (e.g. 2
//   blocks a point at N=40 M=500) they are read from device memory
//   through the read-only path, as are the edge vectors.
//
//   Streaming form (lanes_half_step, slb_lanes_chunk_f32): two launches
//   per step over all cells of the chunk, the launch boundary as the
//   grid-wide dependency; every thread evaluates its point's trig.  It
//   serves points no portable cluster holds (e.g. N=100 M=4000: 6.8 MB a
//   point):
//   - launch 1, the main half-step: writes a, b in place and reads only
//     a_hs, b_hs as neighbours; m+-1 wrap over the packed axis (B4's
//     roll);
//   - launch 2, the half-grid half-step: writes a_hs, b_hs in place and
//     reads the new a, b; its blocks of rows 0-7 then update the av and
//     capture rows of their columns from rows 0-1 of the new a, b.
//   A block is 128 consecutive columns by 8 rows; MP is a multiple of
//   128, so a block's columns lie in one segment and its per-point
//   scalars and trig are uniform.
//
// Both forms compute every cell with half_step.cuh's cell_update and the
// same expressions for mu, the ghost fill, the edge column and the av and
// capture rows, so they agree bit for bit with each other and with the
// plain version.
//
// What bounds it on the H100: the least time for the same work is its
// arithmetic, as for the stacked sweep kernel (chip_smoke.py
// main_path_flops).  The streaming form walks a chunk's state through L2
// twice a step in two launches, each short of a full wave of blocks at 16
// points.  The cluster form removes the walk, the launches and the
// per-thread trig; what bounds it is each SM's work on its R*MP cells
// (the arithmetic with the IEEE division, the shared loads) and a fixed
// cost a step of about 2-4 us: the latency of the two phases, the two
// cluster barriers and rank 0's av update, which is why a0, phi and the
// weights sit in shared memory.  Only 15 clusters of 8 blocks run at once
// on an H100 (17 of 6, 66 of 2), so lanes_cluster_plan counts waves:
// a chunk of 16 points at N=40 M=500 takes 6 blocks of 8 rows in one
// wave, one chunk of 64 takes 2 blocks of 24 rows.  On an H100 80GB HBM3
// at 700 W the 64-point sweep took 32.1-32.4 us per step in chunks of 16
// (streaming form 61.6-63.7) and 20.1-20.3 in one chunk of 64 (streaming
// form 35.2-35.6; PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "half_step.cuh"

namespace cg = cooperative_groups;

namespace {

using slb::Params;

// columns and rows of a block (MP is a multiple of 128, NHP of 8:
// models/superlattice.py round_up)
constexpr int LANE_COLS = 128;
constexpr int LANE_ROWS = 8;

// per-point columns of the (CB, SEG_COLS) table (lane order:
// slb2d_tpu_torch/ops/sweep_lanes_cuda.py SEG_*)
constexpr int SEG_COLS = 8;
constexpr int SEG_EDC = 0, SEG_EOM = 1, SEG_B = 2, SEG_BDT = 3,
              SEG_OMEGA = 4, SEG_EGATE = 5, SEG_TEND = 6;

// packed weight rows (sweep_lanes_cuda.py W_ROWS order)
constexpr int W_AV = 0, W_AV_PHI = 1, W_D4 = 2, W_D4_PHI = 3;

// The cluster form's shared-memory budget (sweep_lanes_cuda.py
// cluster_smem_bytes mirrors these; tests/test_torch_sweep_lanes_cluster.py
// holds the two to each other): a block's opt-in shared memory on an H100,
// the largest portable cluster, a rank's slab arrays (a, b, a_hs, b_hs),
// its rows of a0 and a0_ghost (staged where they fit), the point's rows of
// one column each (av 8, capture 4, the weights 4, phi 1; every rank's
// allocation has them, rank 0's uses the av, capture and weight rows), and
// the static trig buffer (floats).
constexpr int SMEM_LIMIT = 232448;
constexpr int CLUSTER_MAX = 8;
constexpr int SLAB_ARRAYS = 4;
constexpr int A0_ARRAYS = 2;
constexpr int COLUMN_ROWS = 17;
constexpr int TRIG_SCRATCH = 16;
// threads of a cluster-form block
constexpr int CLUSTER_BLOCK = 1024;
// returned when no cluster of the launch fits on the card at once
constexpr int NO_ACTIVE_CLUSTER = -1;
// the trig buffer: two steps (by parity) of TRIG_SLOTS slots, of which
// TRIG_VALUES are used: cos wt, cos w(t+dt), cos w t_hs, cos w(t_hs+dt),
// sin wt
constexpr int TRIG_SLOTS = TRIG_SCRATCH / 2;
constexpr int TRIG_VALUES = 5;

size_t cluster_smem_bytes(int R, int MP, bool staged) {
  return ((size_t)(SLAB_ARRAYS + (staged ? A0_ARRAYS : 0)) * R +
          COLUMN_ROWS) * MP * sizeof(float);
}

bool within_budget(size_t smem) {
  return smem + TRIG_SCRATCH * sizeof(float) <= (size_t)SMEM_LIMIT;
}

// whether a rank of R rows stages its a0 and a0_ghost rows: wherever they
// fit beside the slab
bool stages_a0(int R, int MP) {
  return within_budget(cluster_smem_bytes(R, MP, true));
}

// scalars every point shares (sweep_lanes_cuda.py SCALAR_FIELDS order,
// then t_start and the loop t of the first step)
struct Shared {
  float dt, nu, nu2, nu_tilde, t_start;
};

struct Lanes {
  int N, M, NHP, MP, BMP;   // BMP = CB * MP packed columns
};

// One half-step of every cell of the chunk; with MAIN = false also the
// per-lane av and capture update.  dst arrays are updated in place (a
// cell reads dst only at its own index); nb arrays are not written during
// the launch.  edge_a, edge_b, av, cap and w are used only when !MAIN.
template <bool MAIN>
__global__ void __launch_bounds__(LANE_COLS)
    lanes_half_step(float* a_dst, float* b_dst,
                    const float* __restrict__ a_nb,
                    const float* __restrict__ b_nb,
                    const float* __restrict__ a0,
                    const float* __restrict__ a0_ghost,
                    const float* __restrict__ phi,
                    const float* __restrict__ seg,
                    const float* __restrict__ edge_a,
                    const float* __restrict__ edge_b, float* av, float* cap,
                    const float* __restrict__ w, Shared s, Lanes g, float t,
                    float gf) {
  const int j = blockIdx.x * LANE_COLS + threadIdx.x;   // packed column
  const int sg = j / g.MP;                              // its point
  const int m = j - sg * g.MP;
  const float* q = seg + (size_t)sg * SEG_COLS;
  const float om = q[SEG_OMEGA];
  const Params<float> p = {q[SEG_EDC], q[SEG_EOM], om,         q[SEG_B],
                           s.dt,       s.nu,       s.nu2,      s.nu_tilde,
                           q[SEG_BDT], s.t_start,  0.f};

  // the step's trig of this point, and the column's mu parts in the C
  // operand order (src/boltzmann_c_solver.c:363-365)
  float cos_t, cos_t_dt;
  if (MAIN) {
    cos_t = cosf(om * t);
    cos_t_dt = cosf(om * (t + s.dt));
  } else {
    const float t_hs = t + s.dt / 2.f;
    cos_t = cosf(om * t_hs);
    cos_t_dt = cosf(om * (t_hs + s.dt));
  }
  const float ph = phi[j];
  const float mu_part = (p.E_dc + p.E_omega * cos_t + p.B * ph) * s.dt / 2.f;
  const float mu1_part =
      (p.E_dc + p.E_omega * cos_t_dt + p.B * ph) * s.dt / 2.f;
  const int m_hi = MAIN ? g.M + 1 : g.M;
  const float colf = (m >= 1 && m <= m_hi) ? 1.f : 0.f;
  // m+-1 wrap over the packed axis (B4's roll)
  const int jp1 = j + 1 == g.BMP ? 0 : j + 1;
  const int jm1 = j == 0 ? g.BMP - 1 : j - 1;

  const int n0 = blockIdx.y * LANE_ROWS;
  for (int n = n0; n < n0 + LANE_ROWS; ++n) {
    // row masks and weights (models/superlattice.py: n_float, n_ge2, w_n,
    // row_update, b_row_mask)
    const float nf = n < g.N ? float(n) : 0.f;
    const float n_ge2 = n >= 2 ? 1.f : 0.f;
    const float w_n = n == 0 ? 0.f : (n == 1 ? 2.f : 1.f);
    const float nu_a = s.nu * (n < g.N ? 1.f : 0.f);
    const float nu_b = nu_a * (n > 0 ? 1.f : 0.f);
    const int np1 = n + 1 == g.NHP ? 0 : n + 1;
    const int nm1 = n == 0 ? g.NHP - 1 : n - 1;
    const size_t rp = (size_t)np1 * g.BMP, rm = (size_t)nm1 * g.BMP;
    const size_t idx = (size_t)n * g.BMP + j;
    float a_new, b_new;
    slb::cell_update<float>(
        a_dst[idx], b_dst[idx], b_nb[rp + jp1] - b_nb[rp + jm1],
        b_nb[rm + jp1] - b_nb[rm + jm1], a_nb[rp + jp1] - a_nb[rp + jm1],
        a_nb[rm + jp1] - a_nb[rm + jm1], a0[idx], nf * mu_part,
        nf * mu1_part, nu_a, nu_b, n_ge2, w_n, colf, p, a_new, b_new);
    if (MAIN) {
      a_new = a_new + gf * a0_ghost[idx];
    } else {
      const bool edge = m == g.M + 1;
      const size_t e = (size_t)sg * g.NHP + n;
      a_new = a_new + gf * (edge ? edge_a[e] : 0.f);
      b_new = b_new + gf * (edge ? edge_b[e] : 0.f);
    }
    a_dst[idx] = a_new;
    b_dst[idx] = b_new;
  }

  if (MAIN || blockIdx.y != 0) return;
  // per-lane av() (reference src/boltzmann_c_solver.c:413-437, E_omega > 0
  // gate :188) and loop-exit capture (:236-244) from rows 0-1 of the new
  // main arrays, which are a_nb, b_nb here; row k of av and cap at k * BMP
  const size_t L = g.BMP;
  const float live = t < q[SEG_TEND] ? 1.f : 0.f;
  const float gate = live * q[SEG_EGATE] * (t >= s.t_start ? 1.f : 0.f);
  const float x_dr = b_nb[L + j] * w[W_AV * L + j];
  const float x_vy = a_nb[j] * w[W_AV_PHI * L + j];
  const float x_mx = a_nb[L + j] * w[W_AV * L + j];
  float* r = av + j;
  const float count = r[0] + gate;
  const float den = count > 0.f ? count : 1.f;
  const float av1 = r[L] + gate * (x_dr - r[L]) / den;
  const float av2 = r[2 * L] + gate * (x_vy - r[2 * L]) / den;
  const float av3 = r[3 * L] + gate * (x_mx - r[3 * L]) / den;
  const float cos_av = cosf(om * t);
  const float sin_av = sinf(om * t);
  const float y4 = cos_av * x_dr * s.dt - r[6 * L];
  const float t4 = r[4 * L] + y4;
  const float c4 = (t4 - r[4 * L]) - y4;
  const float y5 = sin_av * x_dr * s.dt - r[7 * L];
  const float t5 = r[5 * L] + y5;
  const float c5 = (t5 - r[5 * L]) - y5;
  r[0] = count;
  r[L] = av1;
  r[2 * L] = av2;
  r[3 * L] = av3;
  if (gate > 0.f) {
    r[4 * L] = t4;
    r[5 * L] = t5;
    r[6 * L] = c4;
    r[7 * L] = c5;
  }
  if (live > 0.f) {
    cap[j] = b_nb[L + j] * w[W_D4 * L + j];
    cap[L + j] = a_nb[j] * w[W_D4_PHI * L + j];
    cap[2 * L + j] = a_nb[L + j] * w[W_D4 * L + j];
    cap[3 * L + j] = a_nb[j] * w[W_AV * L + j];
  }
}

// Thread k < TRIG_VALUES of the block's last warp (which updates no av
// row while MP <= CLUSTER_BLOCK - 32): the k-th trig value of the step at
// loop t, in the streaming form's expressions, into buf.
__device__ __forceinline__ void step_trig(float* buf, float om, float t,
                                          float dt) {
  const int k = (int)threadIdx.x - (CLUSTER_BLOCK - 32);
  if (k < 0 || k >= TRIG_VALUES) return;
  const float t_hs = t + dt / 2.f;
  float x;
  if (k == 0 || k == 4)
    x = om * t;
  else if (k == 1)
    x = om * (t + dt);
  else if (k == 2)
    x = om * t_hs;
  else
    x = om * (t_hs + dt);
  buf[k] = k == 4 ? sinf(x) : cosf(x);
}

// One cell of a slab: d is the rank's row of the pair it updates (a at
// d, b at d + slab, in place), up and dn rows n+1 and n-1 of the other
// pair (a, then b at + slab); extra_a, extra_b what the parity fill adds
// times gf (MAIN: a0_ghost and nothing; half grid: the edge values at
// column M+1, else 0).  The streaming form's expressions, in its order.
template <bool MAIN>
__device__ __forceinline__ void lanes_cell(
    float* d, int slab, const float* up, const float* dn, int m, int mp1,
    int mm1, int n, float a0v, float extra_a, float extra_b, float mu_part,
    float mu1_part, float colf, float gf, const Params<float>& p,
    const Lanes& g) {
  const float nf = n < g.N ? float(n) : 0.f;
  const float n_ge2 = n >= 2 ? 1.f : 0.f;
  const float w_n = n == 0 ? 0.f : (n == 1 ? 2.f : 1.f);
  const float nu_a = p.nu * (n < g.N ? 1.f : 0.f);
  const float nu_b = nu_a * (n > 0 ? 1.f : 0.f);
  float a_new, b_new;
  slb::cell_update<float>(
      d[m], d[slab + m], up[slab + mp1] - up[slab + mm1],
      dn[slab + mp1] - dn[slab + mm1], up[mp1] - up[mm1], dn[mp1] - dn[mm1],
      a0v, nf * mu_part, nf * mu1_part, nu_a, nu_b, n_ge2, w_n, colf, p,
      a_new, b_new);
  a_new = a_new + gf * extra_a;
  if (!MAIN) b_new = b_new + gf * extra_b;
  d[m] = a_new;
  d[slab + m] = b_new;
}

// One half-step over a rank's slab sm (a, b, a_hs, b_hs at 0, slab,
// 2 slab, 3 slab; p_sm, n_sm the previous and next ranks' slabs in
// distributed shared memory).  The thread's columns are m0, m0 +
// mstride, ... (m0 >= MP: none) and its rows l0, l0 + G, ...; a warp's
// threads share their rows (MP is a multiple of 128), so the interior /
// boundary branch is uniform across it.  a0 and a0_ghost point at the
// rank's first row of the point (row stride a0_stride), phi at its first
// column, edge_a and edge_b at the point's edge vectors.
template <bool MAIN>
__device__ __forceinline__ void lanes_slab_half_step(
    float* sm, const float* p_sm, const float* n_sm, int slab, int R,
    int row0, const float* __restrict__ a0,
    const float* __restrict__ a0_ghost, const float* __restrict__ phi,
    const float* __restrict__ edge_a, const float* __restrict__ edge_b,
    const Params<float>& p, const Lanes& g, float cos_t, float cos_t_dt,
    float gf, int m0, int mstride, int l0, int G, int a0_stride) {
  const int MP = g.MP;
  float* const dst = sm + (MAIN ? 0 : 2 * slab);
  const int nb = MAIN ? 2 * slab : 0;     // the other pair
  const int m_hi = MAIN ? g.M + 1 : g.M;
  for (int m = m0; m < MP; m += mstride) {
    // the column's mu parts in the C operand order
    // (src/boltzmann_c_solver.c:363-365), once for all its rows
    const float ph = phi[m];
    const float mu_part =
        (p.E_dc + p.E_omega * cos_t + p.B * ph) * p.dt / 2.f;
    const float mu1_part =
        (p.E_dc + p.E_omega * cos_t_dt + p.B * ph) * p.dt / 2.f;
    const float colf = (m >= 1 && m <= m_hi) ? 1.f : 0.f;
    // m+-1 wrap within the point's own columns
    const int mp1 = m + 1 == MP ? 0 : m + 1;
    const int mm1 = m == 0 ? MP - 1 : m - 1;
    const bool edge = !MAIN && m == g.M + 1;
    for (int l = l0; l < R; l += G) {
      const int n = row0 + l;
      const size_t gi = (size_t)l * a0_stride + m;
      const float a0v = a0[gi];
      float ea = 0.f, eb = 0.f;
      if (MAIN) {
        ea = a0_ghost[gi];
      } else if (edge) {
        ea = edge_a[n];
        eb = edge_b[n];
      }
      float* const d = dst + l * MP;
      if (l > 0 && l + 1 < R) {   // both neighbours in this rank
        const float* const row = sm + nb + l * MP;
        lanes_cell<MAIN>(d, slab, row + MP, row - MP, m, mp1, mm1, n, a0v,
                         ea, eb, mu_part, mu1_part, colf, gf, p, g);
      } else {                    // one in the next or the previous rank
        const float* const up = (l + 1 < R ? sm + (l + 1) * MP : n_sm) + nb;
        const float* const dn =
            (l > 0 ? sm + (l - 1) * MP : p_sm + (R - 1) * MP) + nb;
        lanes_cell<MAIN>(d, slab, up, dn, m, mp1, mm1, n, a0v, ea, eb,
                         mu_part, mu1_part, colf, gf, p, g);
      }
    }
  }
}

// The cluster form: a cluster of CS blocks per point of the chunk (blocks
// s*CS .. s*CS + CS - 1 own point s), each holding R = NHP / CS rows of
// the point's state in shared memory for all n_steps, rank 0 also its av
// and capture rows.  Arguments as lanes_half_step's, with the loop t of
// the first step and the step count; parity0 is the run's step count
// before the first step modulo 2.  The state arrays, av and cap carry no
// __restrict__: they are read and written here only at the launch's
// start and end.
template <bool STAGED>
__global__ void __launch_bounds__(CLUSTER_BLOCK)
    lanes_cluster(float* a, float* b, float* a_hs, float* b_hs, float* av,
                  float* cap, const float* __restrict__ a0,
                  const float* __restrict__ a0_ghost,
                  const float* __restrict__ phi,
                  const float* __restrict__ w,
                  const float* __restrict__ seg,
                  const float* __restrict__ edge_a,
                  const float* __restrict__ edge_b, Shared s, Lanes g,
                  float t, int n_steps, int parity0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float trig[2][TRIG_SLOTS];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int sg = blockIdx.x / cs;                     // the point
  const int MP = g.MP;
  const int R = g.NHP / cs;
  const int slab = R * MP;
  const int row0 = rank * R;
  const size_t L = g.BMP;
  const size_t js = (size_t)sg * MP;                  // its first column
  const size_t off = (size_t)row0 * L + js;           // the rank's rows
  float* const s_a0 = sm + SLAB_ARRAYS * slab;        // STAGED: a0, then
                                                      // a0_ghost rows
  float* const s_av = s_a0 + (STAGED ? A0_ARRAYS * slab : 0);   // 8 rows
  float* const s_cap = s_av + 8 * MP;                 // 4 rows
  float* const s_w = s_cap + 4 * MP;                  // 4 rows, W_* order
  float* const s_phi = s_w + 4 * MP;                  // 1 row

  for (int k = threadIdx.x; k < slab; k += CLUSTER_BLOCK) {
    const int l = k / MP;
    const size_t gi = off + (size_t)l * L + (k - l * MP);
    sm[k] = a[gi];
    sm[slab + k] = b[gi];
    sm[2 * slab + k] = a_hs[gi];
    sm[3 * slab + k] = b_hs[gi];
    if (STAGED) {
      s_a0[k] = a0[gi];
      s_a0[slab + k] = a0_ghost[gi];
    }
  }
  for (int m = threadIdx.x; m < MP; m += CLUSTER_BLOCK) s_phi[m] = phi[js + m];
  if (rank == 0) {
    for (int k = threadIdx.x; k < 8 * MP; k += CLUSTER_BLOCK) {
      const int r = k / MP;
      s_av[k] = av[r * L + js + (k - r * MP)];
    }
    for (int k = threadIdx.x; k < 4 * MP; k += CLUSTER_BLOCK) {
      const int r = k / MP;
      s_cap[k] = cap[r * L + js + (k - r * MP)];
      s_w[k] = w[r * L + js + (k - r * MP)];
    }
  }
  // row row0 - 1 is the previous rank's last row, row row0 + R the next
  // rank's first; both wrap (rank 0's previous is the last rank)
  const float* const p_sm =
      cluster.map_shared_rank(sm, rank == 0 ? cs - 1 : rank - 1);
  const float* const n_sm =
      cluster.map_shared_rank(sm, rank + 1 == cs ? 0 : rank + 1);

  const float* q = seg + (size_t)sg * SEG_COLS;
  const float om = q[SEG_OMEGA];
  const float egate = q[SEG_EGATE], t_end = q[SEG_TEND];
  const Params<float> p = {q[SEG_EDC], q[SEG_EOM], om,         q[SEG_B],
                           s.dt,       s.nu,       s.nu2,      s.nu_tilde,
                           q[SEG_BDT], s.t_start,  0.f};
  const float* const a0r = STAGED ? s_a0 : a0 + off;
  const float* const a0g = STAGED ? s_a0 + slab : a0_ghost + off;
  const int a0_stride = STAGED ? MP : (int)L;
  const float* const ea = edge_a + (size_t)sg * g.NHP;
  const float* const eb = edge_b + (size_t)sg * g.NHP;

  // the thread's columns and rows: one column (MP <= CLUSTER_BLOCK) and
  // the rows of its group, or columns CLUSTER_BLOCK apart and every row;
  // threads past the last whole group of columns update no cell
  const int cw = MP < CLUSTER_BLOCK ? MP : CLUSTER_BLOCK;
  const int G = CLUSTER_BLOCK / cw;
  const int l0 = threadIdx.x / cw;
  const int m0 = l0 < G ? threadIdx.x - l0 * cw : MP;

  step_trig(trig[0], om, t, s.dt);
  cluster.sync();   // every slab is loaded before a neighbour reads it

  for (int i = 0; i < n_steps; ++i) {
    const float gf = (i + parity0 + 1) % 2 == 0 ? 1.f : 0.f;
    const float* const tr = trig[i & 1];

    // phase A: main grid
    lanes_slab_half_step<true>(sm, p_sm, n_sm, slab, R, row0, a0r, a0g,
                               s_phi, ea, eb, p, g, tr[0], tr[1], gf, m0, cw,
                               l0, G, a0_stride);
    cluster.sync();

    // phase B: half grid, then rank 0's per-column av() (reference
    // src/boltzmann_c_solver.c:413-437, E_omega > 0 gate :188) and
    // loop-exit capture (:236-244) from rows 0-1 of the new a, b
    lanes_slab_half_step<false>(sm, p_sm, n_sm, slab, R, row0, a0r, a0g,
                                s_phi, ea, eb, p, g, tr[2], tr[3], gf, m0,
                                cw, l0, G, a0_stride);
    if (rank == 0) {
      const float live = t < t_end ? 1.f : 0.f;
      const float gate = live * egate * (t >= s.t_start ? 1.f : 0.f);
      const float cos_av = tr[0], sin_av = tr[4];
      for (int m = threadIdx.x; m < MP; m += CLUSTER_BLOCK) {
        const float x_dr = sm[slab + MP + m] * s_w[W_AV * MP + m];   // b[1]
        const float x_vy = sm[m] * s_w[W_AV_PHI * MP + m];           // a[0]
        const float x_mx = sm[MP + m] * s_w[W_AV * MP + m];          // a[1]
        float* r = s_av + m;
        const float count = r[0] + gate;
        const float den = count > 0.f ? count : 1.f;
        const float av1 = r[MP] + gate * (x_dr - r[MP]) / den;
        const float av2 = r[2 * MP] + gate * (x_vy - r[2 * MP]) / den;
        const float av3 = r[3 * MP] + gate * (x_mx - r[3 * MP]) / den;
        const float y4 = cos_av * x_dr * s.dt - r[6 * MP];
        const float t4 = r[4 * MP] + y4;
        const float c4 = (t4 - r[4 * MP]) - y4;
        const float y5 = sin_av * x_dr * s.dt - r[7 * MP];
        const float t5 = r[5 * MP] + y5;
        const float c5 = (t5 - r[5 * MP]) - y5;
        r[0] = count;
        r[MP] = av1;
        r[2 * MP] = av2;
        r[3 * MP] = av3;
        if (gate > 0.f) {
          r[4 * MP] = t4;
          r[5 * MP] = t5;
          r[6 * MP] = c4;
          r[7 * MP] = c5;
        }
        if (live > 0.f) {
          s_cap[m] = sm[slab + MP + m] * s_w[W_D4 * MP + m];
          s_cap[MP + m] = sm[m] * s_w[W_D4_PHI * MP + m];
          s_cap[2 * MP + m] = sm[MP + m] * s_w[W_D4 * MP + m];
          s_cap[3 * MP + m] = sm[m] * s_w[W_AV * MP + m];
        }
      }
    }
    // the next step's trig (its buffer was last read before the previous
    // step's closing barrier)
    t = t + s.dt;
    step_trig(trig[(i + 1) & 1], om, t, s.dt);
    cluster.sync();
  }

  for (int k = threadIdx.x; k < slab; k += CLUSTER_BLOCK) {
    const int l = k / MP;
    const size_t gi = off + (size_t)l * L + (k - l * MP);
    a[gi] = sm[k];
    b[gi] = sm[slab + k];
    a_hs[gi] = sm[2 * slab + k];
    b_hs[gi] = sm[3 * slab + k];
  }
  if (rank == 0) {
    for (int k = threadIdx.x; k < 8 * MP; k += CLUSTER_BLOCK) {
      const int r = k / MP;
      av[r * L + js + (k - r * MP)] = s_av[k];
    }
    for (int k = threadIdx.x; k < 4 * MP; k += CLUSTER_BLOCK) {
      const int r = k / MP;
      cap[r * L + js + (k - r * MP)] = s_cap[k];
    }
  }
}

using LanesKernel = void (*)(float*, float*, float*, float*, float*, float*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, Shared, Lanes, float, int, int);

// cudaSuccess, or why a cluster of cs blocks cannot hold an (NHP, MP)
// point: past the portable size, not an equal split of NHP into >= 2 rows
// a rank, MP not a multiple of LANE_COLS, or past SMEM_LIMIT
cudaError_t check_cluster(int cs, int NHP, int MP) {
  if (cs < 1 || cs > CLUSTER_MAX || NHP % cs != 0 || NHP / cs < 2 ||
      MP % LANE_COLS != 0)
    return cudaErrorInvalidValue;
  if (!within_budget(cluster_smem_bytes(NHP / cs, MP, false)))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The launch configuration of the cluster form: n_points clusters of cs
// blocks with the rank's slab (and a0 rows where staged) and the column
// rows as dynamic shared memory (the kernel's attribute set to allow it);
// kernel is the instance for that shape.  attr must outlive cfg.
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           LanesKernel& kernel, int n_points, int cs, int NHP,
                           int MP, cudaStream_t st) {
  cudaError_t err = check_cluster(cs, NHP, MP);
  if (err != cudaSuccess) return err;
  const bool staged = stages_a0(NHP / cs, MP);
  const size_t smem = cluster_smem_bytes(NHP / cs, MP, staged);
  kernel = staged ? lanes_cluster<true> : lanes_cluster<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(n_points * cs);
  cfg.blockDim = dim3(CLUSTER_BLOCK);
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

Shared shared_of(const void* params) {
  const float* pr = static_cast<const float*>(params);
  return {pr[0], pr[1], pr[2], pr[3], pr[4]};
}

}  // namespace

// C entry point (bound with ctypes in ops/sweep_lanes_cuda.py).  Every
// array pointer is a device pointer except `params` (6 host values: dt,
// nu, nu2, nu_tilde, t_start, and the loop t of the first step).  State
// arrays are (NHP, n_points*MP), av (8, n_points*MP), cap (4,
// n_points*MP), a0 and a0_ghost (NHP, n_points*MP), phi (n_points*MP),
// w (4, n_points*MP), seg (n_points, SEG_COLS), edge_a and edge_b
// (n_points, NHP).  parity0 is the run's step count before the first step
// modulo 2.  Enqueues two launches per step on `stream`, the loop t
// carried in float on the host as the JAX kernel carries it, does not
// synchronise, and returns 0 or the first launch's cudaError_t.
extern "C" int slb_lanes_chunk_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* av, void* cap,
    const void* a0, const void* a0_ghost, const void* phi, const void* w,
    const void* seg, const void* edge_a, const void* edge_b,
    const void* params, int n_points, int N, int M, int NHP, int MP,
    int n_steps, int parity0, void* stream) {
  if (MP % LANE_COLS != 0 || NHP % LANE_ROWS != 0 || n_points < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pr = static_cast<const float*>(params);
  const Shared s = {pr[0], pr[1], pr[2], pr[3], pr[4]};
  float t = pr[5];
  const Lanes g = {N, M, NHP, MP, n_points * MP};
  const dim3 grid(g.BMP / LANE_COLS, NHP / LANE_ROWS);
  float* fa = static_cast<float*>(a);
  float* fb = static_cast<float*>(b);
  float* fahs = static_cast<float*>(a_hs);
  float* fbhs = static_cast<float*>(b_hs);
  const float* fa0 = static_cast<const float*>(a0);
  const float* fag = static_cast<const float*>(a0_ghost);
  const float* fphi = static_cast<const float*>(phi);
  const float* fseg = static_cast<const float*>(seg);
  for (int i = 0; i < n_steps; ++i) {
    const float gf = (i + parity0 + 1) % 2 == 0 ? 1.f : 0.f;
    lanes_half_step<true><<<grid, LANE_COLS, 0, st>>>(
        fa, fb, fahs, fbhs, fa0, fag, fphi, fseg, nullptr, nullptr, nullptr,
        nullptr, nullptr, s, g, t, gf);
    lanes_half_step<false><<<grid, LANE_COLS, 0, st>>>(
        fahs, fbhs, fa, fb, fa0, fag, fphi, fseg,
        static_cast<const float*>(edge_a), static_cast<const float*>(edge_b),
        static_cast<float*>(av), static_cast<float*>(cap),
        static_cast<const float*>(w), s, g, t, gf);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    t = t + s.dt;
  }
  return 0;
}

// The cluster form (arguments as slb_lanes_chunk_f32's, then the cluster
// size: 1 to 8 blocks a point, dividing NHP).  Enqueues ONE launch for all
// n_steps on `stream` (none for n_steps = 0), does not synchronise, and
// returns 0, the cudaError_t of a refused launch (cudaErrorInvalidValue
// for a cluster that cannot hold the point), or NO_ACTIVE_CLUSTER; a
// refused launch changes nothing.
extern "C" int slb_lanes_cluster_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* av, void* cap,
    const void* a0, const void* a0_ghost, const void* phi, const void* w,
    const void* seg, const void* edge_a, const void* edge_b,
    const void* params, int n_points, int N, int M, int NHP, int MP,
    int n_steps, int parity0, int cluster_size, void* stream) {
  if (n_points < 1 || n_steps < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  LanesKernel kernel;
  cudaError_t err = cluster_config(cfg, attr, kernel, n_points, cluster_size,
                                   NHP, MP, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters == 0) return NO_ACTIVE_CLUSTER;
  if (n_steps == 0) return 0;
  const Lanes g = {N, M, NHP, MP, n_points * MP};
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<float*>(a), static_cast<float*>(b),
      static_cast<float*>(a_hs), static_cast<float*>(b_hs),
      static_cast<float*>(av), static_cast<float*>(cap),
      static_cast<const float*>(a0), static_cast<const float*>(a0_ghost),
      static_cast<const float*>(phi), static_cast<const float*>(w),
      static_cast<const float*>(seg), static_cast<const float*>(edge_a),
      static_cast<const float*>(edge_b), shared_of(params), g,
      static_cast<const float*>(params)[5], n_steps, parity0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What a form takes on this card: out[0] registers a thread, out[1] bytes
// of local memory a thread (spills), out[2] dynamic shared memory a block,
// out[3] clusters of a chunk of n_points that run at once on the whole
// card; cluster_size 0 the streaming form's half-grid kernel (the larger
// of its two), its out[3] the blocks at once.  Returns 0 or the
// cudaError_t of the query.
extern "C" int slb_lanes_form_info(int cluster_size, int NHP, int MP,
                                   int n_points, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err;
  if (cluster_size == 0) {
    err = cudaFuncGetAttributes(&fa, lanes_half_step<false>);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, lanes_half_step<false>, LANE_COLS, 0)) != cudaSuccess)
      return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = 0;
    out[3] = per_sm * sms;
    return 0;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  LanesKernel kernel;
  err = cluster_config(cfg, attr, kernel, n_points, cluster_size, NHP, MP,
                       nullptr);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess)
    return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)cfg.dynamicSmemBytes;
  out[3] = clusters;
  return 0;
}
