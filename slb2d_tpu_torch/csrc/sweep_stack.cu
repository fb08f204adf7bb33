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
// Design: sweep points are independent, as B3 exploits by keeping a point
// group resident in VMEM for a whole chunk.  Here ONE thread block owns
// one point for the whole chunk and loops over its steps, so the batch is
// one launch per chunk.  __syncthreads() takes the place of B1's kernel
// boundaries (stepper.cu):
//   - phase A, the main half-step, writes a, b in place and reads only
//     a_hs, b_hs as neighbours;
//   - barrier;
//   - phase B, the half-grid half-step, writes a_hs, b_hs in place and
//     reads the new a, b as neighbours; the av and capture sums read rows
//     0 and 1 of the new a, b, which phase B does not write, so they run
//     in the same phase, after the thread's half-step cells;
//   - barrier: the next step's phase A reads a_hs, b_hs at n±1, m±1 and
//     overwrites the a, b the sums read.
// B3's "columnar" av (every stacked row carries its own chain) is a VMEM
// layout trick; a per-point block reduction of the sums computes the same
// observables, and thread 0 keeps p's av in registers across the chunk.
//
// What bounds it on the H100: at the 64-point sweep shape (NHP=48,
// MP=512) a point is 24,576 cells per array, 24 cells per thread at 1024
// threads, and its four state arrays (393 KB in float) plus a0 stay in
// the 50 MB L2 for the whole batch (~38 MB).  Each step streams ~10 array
// passes per point through L2 from one SM per point, so one SM's walk
// over its point and the two barriers per step bound it: up to 132 points
// the step time is flat.  The least time for the same work is its
// arithmetic, 28 adds, multiplies and divisions per live cell of a
// half-step at 33.5 T per second, an H100's f32 rate without FMA
// (chip_smoke.py main_path_flops, PERF.md §6); splitting a point over a
// cluster of blocks to fill the card is later work.

#include <cuda_runtime.h>

#include "half_step.cuh"

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

template <typename T, bool PER_OMEGA>
int run_sweep_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b,
                    T* av, T* cap, T* cap_a, T* cap_b, const T* a0,
                    const T* a0_ghost, const T* phi, const T* w_av,
                    const T* w_av_phi, const T* w_d4, const T* w_d4_phi,
                    const T* pp,
                    const T* params, const T* xs, int n_points,
                    int a0_batched, int N, int M, int NHP, int MP,
                    int n_steps, int parity0, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shared<T> s = {params[0], params[1], params[2], params[3]};
  const Geometry g = {N, M, NHP, MP};
  const size_t a0_stride = a0_batched ? (size_t)NHP * MP : 0;
  sweep_chunk<T, PER_OMEGA><<<n_points, SWEEP_BLOCK, 0, st>>>(
      a, b, a_hs, b_hs, edge_a, edge_b, av, cap, cap_a, cap_b, a0, a0_ghost,
      a0_stride, phi, w_av, w_av_phi, w_d4, w_d4_phi, pp, s, xs, g, n_steps,
      parity0);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes in ops/sweep_stack_cuda.py).  Every
// array pointer is a device pointer except `params` (4 host values in
// SCALAR_FIELDS order).  State arrays are (n_points, NHP, MP), edges
// (n_points, NHP), av (n_points, 8), pp (n_points, PP_COLS); a0 and
// a0_ghost are (n_points, NHP, MP) when a0_batched, else (NHP, MP).  The
// per-omega forms (slb_sweep_chunk_omega_*) also take cap (n_points, 4)
// and cap_a, cap_b (n_points, NHP, MP; both null without frames) after
// av, and w_d4, w_d4_phi (MP,) after w_av_phi.  They enqueue ONE
// launch on `stream`, do not synchronise, and return 0 or the cudaError_t
// of the launch.
template <typename T>
int shared_entry(void* a, void* b, void* a_hs, void* b_hs, void* edge_a,
                 void* edge_b, void* av, const void* a0,
                 const void* a0_ghost, const void* phi, const void* w_av,
                 const void* w_av_phi, const void* pp, const void* params,
                 const void* xs, int n_points, int a0_batched, int N, int M,
                 int NHP, int MP, int n_steps, int parity0, void* stream) {
  return run_sweep_chunk<T, false>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      nullptr, nullptr, nullptr, (const T*)a0, (const T*)a0_ghost,
      (const T*)phi, (const T*)w_av, (const T*)w_av_phi, nullptr, nullptr,
      (const T*)pp,
      (const T*)params, (const T*)xs, n_points, a0_batched, N, M, NHP, MP,
      n_steps, parity0, stream);
}

template <typename T>
int omega_entry(void* a, void* b, void* a_hs, void* b_hs, void* edge_a,
                void* edge_b, void* av, void* cap, void* cap_a, void* cap_b,
                const void* a0, const void* a0_ghost, const void* phi,
                const void* w_av, const void* w_av_phi, const void* w_d4,
                const void* w_d4_phi,
                const void* pp, const void* params, const void* xs,
                int n_points, int a0_batched, int N, int M, int NHP, int MP,
                int n_steps, int parity0, void* stream) {
  return run_sweep_chunk<T, true>(
      (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,
      (T*)cap, (T*)cap_a, (T*)cap_b, (const T*)a0, (const T*)a0_ghost,
      (const T*)phi, (const T*)w_av, (const T*)w_av_phi, (const T*)w_d4,
      (const T*)w_d4_phi, (const T*)pp, (const T*)params, (const T*)xs,
      n_points, a0_batched, N, M, NHP, MP, n_steps, parity0, stream);
}

extern "C" int slb_sweep_chunk_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, void* stream) {
  return shared_entry<float>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                             a0_ghost, phi, w_av, w_av_phi, pp, params, xs,
                             n_points, a0_batched, N, M, NHP, MP, n_steps,
                             parity0, stream);
}

extern "C" int slb_sweep_chunk_f64(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, const void* a0, const void* a0_ghost, const void* phi,
    const void* w_av, const void* w_av_phi, const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, void* stream) {
  return shared_entry<double>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                              a0_ghost, phi, w_av, w_av_phi, pp, params, xs,
                              n_points, a0_batched, N, M, NHP, MP, n_steps,
                              parity0, stream);
}

extern "C" int slb_sweep_chunk_omega_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, void* cap, void* cap_a, void* cap_b, const void* a0,
    const void* a0_ghost, const void* phi, const void* w_av,
    const void* w_av_phi, const void* w_d4, const void* w_d4_phi,
    const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, void* stream) {
  return omega_entry<float>(a, b, a_hs, b_hs, edge_a, edge_b, av, cap,
                            cap_a, cap_b, a0, a0_ghost, phi, w_av, w_av_phi,
                            w_d4, w_d4_phi, pp, params, xs, n_points,
                            a0_batched, N, M, NHP, MP, n_steps, parity0,
                            stream);
}

extern "C" int slb_sweep_chunk_omega_f64(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    void* av, void* cap, void* cap_a, void* cap_b, const void* a0,
    const void* a0_ghost, const void* phi, const void* w_av,
    const void* w_av_phi, const void* w_d4, const void* w_d4_phi,
    const void* pp,
    const void* params, const void* xs, int n_points, int a0_batched, int N,
    int M, int NHP, int MP, int n_steps, int parity0, void* stream) {
  return omega_entry<double>(a, b, a_hs, b_hs, edge_a, edge_b, av, cap,
                             cap_a, cap_b, a0, a0_ghost, phi, w_av, w_av_phi,
                             w_d4, w_d4_phi, pp, params, xs, n_points,
                             a0_batched, N, M, NHP, MP, n_steps, parity0,
                             stream);
}
