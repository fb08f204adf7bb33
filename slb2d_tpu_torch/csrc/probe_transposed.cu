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
// masks zero them, and they are read all the same: x·0 may differ from 0
// in its sign bit).  The padding columns n >= NHP are never written.
//
// Two forms, B1's two (perf/transposed_experiment.py picks one by name):
//
//   Resident form (t_resident_chunk; slb_transposed_resident_f32): the
//   counterpart of B1's resident_chunk in its in-order step (as
//   band_step.cuh's spill_band_chunk steps, without the slab, av and
//   records) in the (m, n) layout.  ONE cooperative launch per
//   chunk, one block per SM; block k holds the band of rows
//   [k·R, min((k+1)·R, MP)) of a, b (HALO_MAIN rows on each side) and of
//   a_hs, b_hs (HALO_HALF rows) in dynamic shared memory for the whole
//   chunk.  A step: the main half-step on the band's rows AND its a, b halo
//   rows (what the neighbours compute as their own, from the same inputs,
//   so the same bits); a block barrier; the half-grid half-step on the
//   band's rows, publishing its first two and last two rows of a_hs, b_hs
//   to the exchange buffer xch (by step parity); ONE grid barrier; the
//   neighbours' rows read into the a_hs, b_hs halo.  A halo row is NHL
//   contiguous floats, so the exchange is coalesced 16-byte loads (B1's
//   halo is a strided column).  The thread of lane n holds column n for the
//   chunk: its row terms (nf, n_ge2, w_n, nu_a, nu_b) and n±1 offsets are
//   computed once; each row's mu parts, (E_dc + E_omega·cos + B·phi)·dt/2,
//   once per half-step into a shared table (B1 computes its column's once
//   per half-step).  a0 is read through the read-only path, a0_ghost only
//   off the interior (rows m = 0, m >= M+2, columns n >= N), as in B1.  The
//   price of the layout: NHL lanes for NHP live harmonics.
//
//   Per-half-step form (t_half_step; slb_transposed_chunk_f32): two
//   launches per step, one thread per padded cell, the state in device
//   memory (L2), the kernel boundary as the barrier between the
//   half-steps; B1's per-half-step form without av_step.
//
// What bounds it: the same arithmetic as B1's step, 28 adds, multiplies
// and divisions per live cell of a half-step (the count of
// benchmark/harness/roofline.py); the per-half-step form walks 5-6 (MP, NHL) arrays
// through L2 per half-step (~2.1 MB each at BASELINE #4, 23% more than
// B1's (NHP, MP) arrays) and pays two launches per step; the resident form
// removes both, and what is left is each SM's cell loop and the grid
// barrier of a step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "band_step.cuh"
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

// ---- the resident form -----------------------------------------------

namespace cg = cooperative_groups;
using slb::HALO_HALF;
using slb::HALO_MAIN;
using slb::NOT_CO_RESIDENT;
using slb::RESIDENT_BLOCK;
using slb::SMEM_LIMIT;
using slb::XS_STAGE;

// The resident form's budget (perf/transposed_experiment.py resident_plan
// mirrors these and band_step.cuh's SMEM_LIMIT, HALO_MAIN, HALO_HALF,
// XS_STAGE and RESIDENT_BLOCK; tests/test_torch_probes_resident.py holds
// them to each other): a band's rows come in units of ROW_ALIGN (it
// publishes two rows on each side, and MP is even) up to MAX_ROWS; the
// rows a band publishes per step, its first two and last two of a_hs and
// b_hs; the tables of each row's mu parts (main cos_t, cos_t_dt; half grid
// cos_hs, cos_hs_dt), one entry per row of the band and its a, b halo,
// beside the rows' phi.
constexpr int ROW_ALIGN = 2;
constexpr int MAX_ROWS = 512;
constexpr int T_XCH_ROWS = 8;
constexpr int MU_TABLES = 4;

// The dynamic shared memory of a band of R rows: a, b with HALO_MAIN rows
// on each side, a_hs, b_hs with HALO_HALF, XS_STAGE + 1 rows of the xs
// table, the phi row and the MU_TABLES tables
size_t t_resident_smem_bytes(int NHL, int R) {
  return ((size_t)2 * (R + 2 * HALO_MAIN) * NHL +
          (size_t)2 * (R + 2 * HALO_HALF) * NHL +
          (size_t)(XS_STAGE + 1) * XS_LANES +
          (size_t)(MU_TABLES + 1) * (R + 2 * HALO_MAIN)) * sizeof(float);
}

__device__ __forceinline__ int wrap_row(int m, int MP) {
  return m < 0 ? m + MP : (m >= MP ? m - MP : m);
}

// Block k of gridDim.x bands holds band k for the whole chunk.  Shared
// memory: a, b (R + 2 rows of NHL, band-local row j at j + HALO_MAIN),
// a_hs, b_hs (R + 4 rows, j at j + HALO_HALF), the staged xs rows, phi of
// rows -1..Wb, and the mu tables (MU_TABLES x (R + 2)).  xch holds 2 step
// parities x bands x T_XCH_ROWS x NHL values, row q = (side · 2 + which)
// · 2 + array of the publishing band (side 0: its first two rows, 1: its
// last two).  The state arrays carry no __restrict__: they are read at the
// start and written at the end.
__global__ void __launch_bounds__(RESIDENT_BLOCK, 1)
    t_resident_chunk(float* a, float* b, float* a_hs, float* b_hs,
                     float* edge_a, float* edge_b,
                     const float* __restrict__ a0,
                     const float* __restrict__ a0_ghost,
                     const float* __restrict__ phi,
                     const float* __restrict__ xs, float* xch,
                     Params<float> p, TGeometry g, int R, int n_steps,
                     int parity0) {
  extern __shared__ __align__(16) float sm[];
  cg::grid_group grid = cg::this_grid();
  const int NHL = g.NHL, NHP = g.NHP, MP = g.MP, NV = NHL / 4;
  const int band = blockIdx.x, nb = gridDim.x;
  const int c0 = band * R, Wb = min(R, MP - c0);
  const int RA = R + 2 * HALO_MAIN, RH = R + 2 * HALO_HALF;
  float* const sA = sm;
  float* const sB = sA + RA * NHL;
  float* const sAh = sB + RA * NHL;
  float* const sBh = sAh + RH * NHL;
  float* const sX = sBh + RH * NHL;
  float* const sPhi = sX + (XS_STAGE + 1) * XS_LANES;
  float* const sMu = sPhi + RA;

  // the lane's column n: its row terms (half_step_cell's) and n±1
  const int n = threadIdx.x % NHL, r0 = threadIdx.x / NHL;
  const int RG = blockDim.x / NHL;
  const bool live = n < NHP;
  const float nf = n < g.N ? float(n) : 0.0f;
  const float n_ge2 = n >= 2 ? 1.0f : 0.0f;
  const float w_n = n == 0 ? 0.0f : (n == 1 ? 2.0f : 1.0f);
  const float nu_a = p.nu * (n < g.N ? 1.0f : 0.0f);
  const float nu_b = nu_a * (n > 0 ? 1.0f : 0.0f);
  const int dp = (n + 1 == NHP ? 0 : n + 1) - n;
  const int dm = (n == 0 ? NHP - 1 : n - 1) - n;
  const bool ghost_row = n >= g.N;
  const int left = band == 0 ? nb - 1 : band - 1;
  const int right = band + 1 == nb ? 0 : band + 1;
  const size_t slot = (size_t)T_XCH_ROWS * NHL;

  // each row's mu parts of one step from its xs row, rows -1..Wb
  auto mu_tables = [&](const float* row) {
    for (int k = threadIdx.x; k < MU_TABLES * (Wb + 2 * HALO_MAIN);
         k += blockDim.x) {
      const int t = k / (Wb + 2 * HALO_MAIN);
      const int jj = k - t * (Wb + 2 * HALO_MAIN);
      sMu[t * RA + jj] =
          (p.E_dc + p.E_omega * row[t] + p.B * sPhi[jj]) * p.dt / 2.0f;
    }
  };

  // the band and its halo rows (the row wrap of the plain version)
  for (int k = threadIdx.x; k < (Wb + 2 * HALO_MAIN) * NV; k += blockDim.x) {
    const int jj = k / NV, q = k - jj * NV;
    const size_t gr = (size_t)wrap_row(c0 - HALO_MAIN + jj, MP) * NHL;
    reinterpret_cast<float4*>(sA + jj * NHL)[q] =
        reinterpret_cast<const float4*>(a + gr)[q];
    reinterpret_cast<float4*>(sB + jj * NHL)[q] =
        reinterpret_cast<const float4*>(b + gr)[q];
  }
  for (int k = threadIdx.x; k < (Wb + 2 * HALO_HALF) * NV; k += blockDim.x) {
    const int jj = k / NV, q = k - jj * NV;
    const size_t gr = (size_t)wrap_row(c0 - HALO_HALF + jj, MP) * NHL;
    reinterpret_cast<float4*>(sAh + jj * NHL)[q] =
        reinterpret_cast<const float4*>(a_hs + gr)[q];
    reinterpret_cast<float4*>(sBh + jj * NHL)[q] =
        reinterpret_cast<const float4*>(b_hs + gr)[q];
  }
  for (int jj = threadIdx.x; jj < Wb + 2 * HALO_MAIN; jj += blockDim.x)
    sPhi[jj] = phi[wrap_row(c0 - HALO_MAIN + jj, MP)];
  for (int k = threadIdx.x; k < min(XS_STAGE + 1, n_steps) * XS_LANES;
       k += blockDim.x)
    sX[k] = xs[k];
  __syncthreads();
  mu_tables(sX);
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    // the next XS_STAGE + 1 rows of the table: the last reads of the old
    // ones (the previous step's mu tables) are behind the previous step's
    // closing barrier, the first of these behind this step's phase-A one
    if (i > 0 && i % XS_STAGE == 0)
      for (int k = threadIdx.x; k < min(XS_STAGE + 1, n_steps - i) * XS_LANES;
           k += blockDim.x)
        sX[k] = xs[(size_t)i * XS_LANES + k];
    const float gf = ((i + parity0 + 1) % 2 == 0) ? 1.0f : 0.0f;
    const size_t par = i & 1;

    // phase A: the main grid on the band's rows and its a, b halo rows
    if (live)
      for (int j = r0 - HALO_MAIN; j < Wb + HALO_MAIN; j += RG) {
        const int m = wrap_row(c0 + j, MP);
        const int od = (j + HALO_MAIN) * NHL + n;
        const int on = (j + HALO_HALF) * NHL + n;
        const float dmb_p = sBh[on + NHL + dp] - sBh[on - NHL + dp];
        const float dmb_m = sBh[on + NHL + dm] - sBh[on - NHL + dm];
        const float dma_p = sAh[on + NHL + dp] - sAh[on - NHL + dp];
        const float dma_m = sAh[on + NHL + dm] - sAh[on - NHL + dm];
        const size_t gi = (size_t)m * NHL + n;
        const float colf = (m >= 1 && m <= g.M + 1) ? 1.0f : 0.0f;
        float a_new, b_new;
        slb::cell_update(sA[od], sB[od], dmb_p, dmb_m, dma_p, dma_m,
                         __ldg(a0 + gi), nf * sMu[j + HALO_MAIN],
                         nf * sMu[RA + j + HALO_MAIN], nu_a, nu_b, n_ge2, w_n,
                         colf, p, a_new, b_new);
        // a0_ghost is 0 in the interior: the fill adds gf · 0 there
        const bool ghost = ghost_row || m == 0 || m >= g.M + 2;
        a_new = a_new + gf * (ghost ? __ldg(a0_ghost + gi) : 0.0f);
        sA[od] = a_new;
        sB[od] = b_new;
      }
    __syncthreads();

    // phase B: the half grid on the band's rows against the new a, b; its
    // first two and last two rows out
    float* const pub = xch + (par * nb + band) * slot;
    if (live)
      for (int j = r0; j < Wb; j += RG) {
        const int m = c0 + j;
        const int od = (j + HALO_HALF) * NHL + n;
        const int on = (j + HALO_MAIN) * NHL + n;
        const float dmb_p = sB[on + NHL + dp] - sB[on - NHL + dp];
        const float dmb_m = sB[on + NHL + dm] - sB[on - NHL + dm];
        const float dma_p = sA[on + NHL + dp] - sA[on - NHL + dp];
        const float dma_m = sA[on + NHL + dm] - sA[on - NHL + dm];
        const float a_src = sAh[od], b_src = sBh[od];
        const float colf = (m >= 1 && m <= g.M) ? 1.0f : 0.0f;
        float a_new, b_new;
        slb::cell_update(a_src, b_src, dmb_p, dmb_m, dma_p, dma_m,
                         __ldg(a0 + (size_t)m * NHL + n),
                         nf * sMu[2 * RA + j + HALO_MAIN],
                         nf * sMu[3 * RA + j + HALO_MAIN], nu_a, nu_b, n_ge2,
                         w_n, colf, p, a_new, b_new);
        if (m == g.M + 1) {   // the stale row M+1: the carried edge
          a_new = edge_a[n];
          b_new = edge_b[n];
          edge_a[n] = a_src;
          edge_b[n] = b_src;
        }
        sAh[od] = a_new;
        sBh[od] = b_new;
        if (j < 2) {
          __stcg(pub + (j * 2) * NHL + n, a_new);
          __stcg(pub + (j * 2 + 1) * NHL + n, b_new);
        }
        if (j >= Wb - 2) {   // both, in a band of two or three rows
          const int w = 2 + j - (Wb - 2);
          __stcg(pub + (w * 2) * NHL + n, a_new);
          __stcg(pub + (w * 2 + 1) * NHL + n, b_new);
        }
      }
    grid.sync();

    // the a_hs, b_hs halo rows from the neighbours: rows -2, -1 from the
    // left band's last two, Wb, Wb + 1 from the right band's first two
    const float* const x = xch + par * nb * slot;
    for (int k = threadIdx.x; k < T_XCH_ROWS * NV; k += blockDim.x) {
      const int q = k / NV, c4 = k - q * NV;
      const int arr = q & 1, which = (q >> 1) & 1, side = q >> 2;
      const int j = side ? which - HALO_HALF : Wb + which;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
                                  x + (side ? left : right) * slot +
                                  (size_t)q * NHL) + c4);
      reinterpret_cast<float4*>((arr ? sBh : sAh) +
                                (j + HALO_HALF) * NHL)[c4] = v;
    }
    if (i + 1 < n_steps) mu_tables(sX + (i % XS_STAGE + 1) * XS_LANES);
    __syncthreads();
  }

  for (int k = threadIdx.x; k < Wb * NHP; k += blockDim.x) {
    const int j = k / NHP, nn = k - j * NHP;
    const size_t gi = (size_t)(c0 + j) * NHL + nn;
    a[gi] = sA[(j + HALO_MAIN) * NHL + nn];
    b[gi] = sB[(j + HALO_MAIN) * NHL + nn];
    a_hs[gi] = sAh[(j + HALO_HALF) * NHL + nn];
    b_hs[gi] = sBh[(j + HALO_HALF) * NHL + nn];
  }
}

// cudaSuccess, or why bands of R rows and blocks of `threads` cannot hold
// an (MP, NHL) state: R not a multiple of ROW_ALIGN up to MAX_ROWS, a last
// band of fewer than two rows, a layout the lanes cannot take (NHL below
// NHP, not a multiple of 4, above RESIDENT_BLOCK), threads not whole row
// groups of NHL lanes, at most R of them and RESIDENT_BLOCK threads, or the
// band past SMEM_LIMIT
cudaError_t t_check(int R, int NHP, int MP, int NHL, int threads) {
  if (R < ROW_ALIGN || R > MAX_ROWS || R % ROW_ALIGN != 0 || NHP < 2 ||
      NHL < NHP || NHL % 4 != 0 || NHL > RESIDENT_BLOCK || MP < 2)
    return cudaErrorInvalidValue;
  if (threads < NHL || threads % NHL != 0 || threads > RESIDENT_BLOCK ||
      threads / NHL > R)
    return cudaErrorInvalidValue;
  if (MP - ((MP + R - 1) / R - 1) * R < 2) return cudaErrorInvalidValue;
  if (t_resident_smem_bytes(NHL, R) > (size_t)SMEM_LIMIT)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The launch shape: the shared-memory attribute set, and the blocks the
// card runs at once
cudaError_t t_resident_config(int R, int NHP, int MP, int NHL, int threads,
                              int* at_once) {
  cudaError_t err = t_check(R, NHP, MP, NHL, threads);
  if (err != cudaSuccess) return err;
  const int smem = (int)t_resident_smem_bytes(NHL, R);
  if ((err = cudaFuncSetAttribute(t_resident_chunk,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, t_resident_chunk, threads, smem)) !=
          cudaSuccess)
    return err;
  *at_once = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// C entry points (bound with ctypes in perf/transposed_experiment.py).
//
// The per-half-step form.
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

// The resident form's entry point: the arguments of slb_transposed_chunk_f32
// with the exchange buffer xch (2 x bands x T_XCH_ROWS x NHL values of
// device scratch), the band's rows R and the threads a block (NHL lanes
// times at most R row groups; the plan's: transposed_experiment.py
// resident_threads).  Enqueues ONE cooperative launch of ceil(MP / R)
// blocks on `stream`, does not synchronise, and returns 0,
// the cudaError_t of a refused launch (cudaErrorInvalidValue for bands that
// cannot hold the state), or NOT_CO_RESIDENT; a refused launch changes
// nothing.
extern "C" int slb_transposed_resident_f32(
    void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,
    const void* a0, const void* a0_ghost, const void* phi,
    const void* params, const void* xs, void* xch, int N, int M, int NHP,
    int MP, int NHL, int R, int threads, int n_steps, int parity0,
    void* stream) {
  const float* pr = static_cast<const float*>(params);
  Params<float> p = {pr[0], pr[1], pr[2], pr[3], pr[4], pr[5],
                     pr[6], pr[7], pr[8], pr[9], pr[10]};
  TGeometry g = {N, M, NHP, MP, NHL};
  int at_once = 0;
  cudaError_t err = t_resident_config(R, NHP, MP, NHL, threads, &at_once);
  if (err != cudaSuccess) return (int)err;
  const int bands = (MP + R - 1) / R;
  if (at_once < bands) return NOT_CO_RESIDENT;
  void* args[] = {&a,  &b,   &a_hs, &b_hs, &edge_a, &edge_b,  &a0,
                  &a0_ghost, &phi, &xs, &xch, &p,  &g,  &R, &n_steps,
                  &parity0};
  err = cudaLaunchCooperativeKernel(
      (const void*)t_resident_chunk, dim3(bands),
      dim3(threads), args, t_resident_smem_bytes(NHL, R),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the resident form takes on this card with bands of R rows and
// blocks of `threads`: out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] dynamic
// shared memory a block, out[3] blocks that run at once on the whole
// card, out[4] threads a block, out[5] static shared memory a block.
// Returns 0 or the cudaError_t of the query.
extern "C" int slb_transposed_resident_info(int R, int NHP, int MP, int NHL,
                                            int threads, int* out) {
  int at_once = 0;
  cudaError_t err = t_resident_config(R, NHP, MP, NHL, threads, &at_once);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, t_resident_chunk)) != cudaSuccess)
    return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)t_resident_smem_bytes(NHL, R);
  out[3] = at_once;
  out[4] = threads;
  out[5] = (int)fa.sharedSizeBytes;
  return 0;
}

// What the per-half-step form's two kernels take on this card: out[0..2]
// registers, local (spill) bytes and static shared memory a thread or
// block of t_half_step<true>, out[3..5] of t_half_step<false>, out[6] the
// threads of a block.  Returns 0 or the cudaError_t of the query.
extern "C" int slb_transposed_step_info(int* out) {
  cudaFuncAttributes fa;
  for (int k = 0; k < 2; ++k) {
    const cudaError_t err = cudaFuncGetAttributes(
        &fa, k == 0 ? (const void*)t_half_step<true>
                    : (const void*)t_half_step<false>);
    if (err != cudaSuccess) return (int)err;
    out[3 * k] = fa.numRegs;
    out[3 * k + 1] = (int)fa.localSizeBytes;
    out[3 * k + 2] = (int)fa.sharedSizeBytes;
  }
  out[6] = BLOCK;
  return 0;
}
