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
// m+-1 reads wrap over the packed axis, as B4's rolls do: at a segment's
// column 0 or MP-1 they reach the neighbouring segment, and land only in
// ghost columns, which colf/xi zeroes.  Each point's trig is the same for
// its whole segment; every thread evaluates it with cosf/sinf (never the
// fast intrinsics), as torch.cos does, so the kernel rounds as its plain
// PyTorch version (slb2d_tpu_torch/ops/sweep_lanes_cuda.py:
// run_lanes_plain) does.
//
// Design: two launches per step over all cells of the chunk.  The launch
// boundary is the grid-wide dependency of the stencil (each half-step
// reads the other pair's n+-1, m+-1 neighbours from before it):
//   - launch 1, the main half-step: writes a, b in place and reads only
//     a_hs, b_hs as neighbours;
//   - launch 2, the half-grid half-step: writes a_hs, b_hs in place and
//     reads the new a, b; its blocks of rows 0-7 then update the av and
//     capture rows of their columns from rows 0-1 of the new a, b, which
//     this launch does not write.
// A block is 128 consecutive columns by 8 rows; MP is a multiple of 128,
// so a block's columns lie in one segment and its per-point scalars and
// trig are uniform.  Each thread walks its column's 8 rows with the
// column's mu parts computed once.  One C call enqueues a chunk's steps.
//
// What bounds it on the H100: at the 64-point sweep (NHP=48, MP=512) a
// chunk of 16 points is 48 x 8,192 cells, 1.6 MB per array, and all 64
// points 6.3 MB per array; state, a0, a0_ghost and the av and capture rows
// (~9.8 MB at 16 points, ~39 MB at 64) stay in the 50 MB L2.  A step is
// two passes over the chunk's cells, ~10 array reads and 2 writes per
// cell through L2, and two launches; the least time for the same work is
// its arithmetic, as for the stacked sweep kernel (chip_smoke.py
// main_path_flops).  With max_points=16 the 64-point sweep is four chunks
// run one after the other, eight launches per step of the sweep, each
// short of a full wave of blocks: 64.1 us per step against 36.2 in one chunk
// of 64 (H100 80GB HBM3, 700 W; PERF.md).  Fewer, fuller launches (CUDA
// graphs, a persistent grid) are later work.

#include <cuda_runtime.h>

#include "half_step.cuh"

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
