// Full solver steps for grids past B1's resident plan on an NVIDIA Hopper
// card (sm_90a), float and double, in two forms.
//
// Replaces the Pallas TPU kernel slb2d_tpu/ops/stepper_stream.py:
// _stream_kernel (kernel B2) and the av replay and record gather of its
// runner (stepper_stream.py:391-412).  B2 exists because one TPU core's
// VMEM cannot hold a wide grid and past it there is only HBM, so it tiles
// in time.  An H100 has a different hierarchy: its 132 SMs' shared memory
// (30.7 MB) holds most of such a grid, and its 50 MB L2 the rest.
//
// Spill form (spill_chunk; slb_stream_spill_chunk_*): B1's resident band
// loop in its in-order step (band_step.cuh: spill_band_chunk, a resident
// part and a slab a band), one cooperative launch per chunk, one block per SM, one grid barrier per step, no halo
// recomputed across steps, no replay launch, no round trip of the state.
// Each block keeps the first R columns of its band in shared memory and
// the rest (S, 24-25 at N=100 M=20000 in float: 3,200 columns in all) in
// a slab of device memory that stays in L2; its spill cells follow its
// resident rows in each half-step.  What bounds it: the arithmetic, as
// for B1 (benchmark/harness/roofline.py); what its design leaves is B1's
// cell loop and fixed cost per step, plus the spill cells, each of which
// reads its ten values from L1 or L2 instead of shared memory.
// ops/stepper_stream_cuda.py:spill_plan sizes it (R = 128 at NHP = 104 in
// float) and holds it to an L2 budget; past that the tiling form runs.
//
// Tiling form (stream_tile, stream_replay; slb_stream_chunk_*): what B2
// computes on the TPU: the
// phi_y axis is cut into tiles of W center columns; each tile, with an
// H-column halo on each side (local columns 0..WT-1, WT = W + 2H), advances
// K full steps on its own, and its W center columns are exact after them
// because one full step spreads information by 2 columns (two half-steps of
// an (n±1, m±1) stencil) and H >= 2K (the trapezoid bound).  Every step of
// a tile is the step of stepper.cu on the tile's cells (tile_half_step,
// with half_step.cuh's cell_update): main-grid half-step, parity ghost
// fill, half-grid half-step, and the stale column M+1 of the half-step
// arrays, whose
// retired-edge chain every tile covering M+1 keeps locally; only the tile
// whose CENTER owns M+1 writes the edges out.  Per step a tile writes the
// raw sums of its center columns (norm, v_dr, v_y, m_x; w_av and w_av_phi
// are 0 at padding) to a (K, n_tiles, 4) buffer, without atomics, and a
// one-block replay kernel adds them in tile order and runs the
// Kahan-compensated av() chain gated by xs lane 6, writing display-77
// records (pre-step sums, loop t, post-step av) where xs lane 8 is set.
//
// Design of the tiling form for Hopper: B2 keeps a (NHP, W + 2·128)
// working set in a TPU core's VMEM for 64 steps (W = 2048).  A thread
// block has at most 227 KB of shared memory, 136 columns at NHP = 104 in
// float, so here K = 4 and H = 8 by default (ops/stepper_stream_cuda.py;
// K = 2..16 measured), and the four working arrays of a tile live in
// dynamic shared memory when they fit (SMEM = true), else in a per-block
// scratch in global memory that stays in L2 (double at NHP = 408).  W is
// chosen on the host for the fewest waves x (W + 2H) over the card's SMs.
// Each thread keeps one column of its tile and walks its rows, so a
// column's mu parts and masks are computed once per half-step.
// One block of 1024 threads per tile loops over the K steps with a block
// barrier between the two half-steps (as sweep_stack.cu does per point);
// tiles are independent within a launch, so the launch boundary is the
// only grid-wide barrier, once per K steps.  Overlapping tiles read their
// neighbours' pre-launch centers as halo, so launches ping-pong between
// the state and a second buffer set; after an odd number of launches the
// chunk copies the result back, so the caller's tensors hold it.
//
// What bounds it: per step each block walks its NHP x WT cells twice from
// shared memory (8 neighbour loads and 2 stores per cell), with a0, phi and
// a0_ghost from L2; global traffic is one read of the extended tiles and
// one write of the centers per K steps.  The least time for the same work
// is its arithmetic (benchmark/harness/roofline.py, as for stepper.cu);
// the halo columns (WT/W more cells) are this kernel's overhead.  Measured
// in float on an H100 80GB HBM3 at 700 W (PERF.md): 25.2 us per step at
// N=100 M=12000 against 30.6 for stepper.cu, ~8% of the operation bound,
// the tile walk latency bound (each thread's rows in sequence); 12.8 us at
// N=100 M=4000; at N=400 M=4000 only W=18 fits and stepper.cu is faster.
//
// Per-step trig and gates come from a device copy of the chunk's xs table
// (lane order: slb2d_tpu_torch/ops/stepper_cuda.py XS_LANES; lanes 8 and 9
// carry the display-77 emission flag and record slot); physics scalars
// arrive in SCALAR_FIELDS order.

#include <cuda_runtime.h>

#include "band_step.cuh"
#include "half_step.cuh"

namespace {

using slb::Geometry;
using slb::OBS_LANES;
using slb::Params;
using slb::XS_LANES;

constexpr int TILE_BLOCK = 1024;
constexpr int SUMS = 4;                       // norm, v_dr, v_y, m_x
constexpr int REPLAY_BLOCK = 128;
constexpr int MAX_K = REPLAY_BLOCK / SUMS;    // steps per launch at most

// A launch's tiles over an array of `ld` columns a row whose column 0 is
// global column `base`: the tiles' centres cover the array's columns
// [own_lo, own_hi), W a tile; a column is on the grid where it lies in the
// array and its global column in [0, MP).  The whole grid: ld = MP,
// base = 0, [0, MP).  A shard's extended slice (the sharded form):
// ld = L + 2H, base = shard * L - H, [H, H + L): its halo columns are read
// but never written.  Tile t's step sums go to partials slot
// (s * part_stride + part_off + t).
struct Tiling {
  int W, H, WT, n_tiles;
  int ld, base, own_lo, own_hi;
  int part_off, part_stride;
};

// A thread's cells of a tile: columns l0, l0 + dl, ... and, in each,
// rows n0, n0 + dn, ...; with WT <= 1024 every thread keeps one column
// and walks its rows.  Threads past the last full row set have none.
struct Lanes {
  int l0, dl, n0, dn;
};

// One half-step over the tile's cells, in place in dst (the cell reads dst
// only at its own cell and its neighbours from nb, which no thread of the
// phase writes).  Neighbour reads wrap within the tile, as torch.roll
// wraps the plain version's tile batch: a wrapped value reaches only halo
// columns within a launch (the trapezoid bound).  a0, a0_ghost, phi and
// the observable weights are arrays of the launch's columns (la); the
// column masks follow the global column mg; all read as 0 off the grid
// (outside the array or mg outside [0, MP)), so cells there stay finite
// and masked.  Per column
// the mu parts (E_dc + E_omega cos + B phi) dt / 2 are computed once and
// multiplied by each row's n, the operations of half_step_cell.  The half
// grid's stale column M+1 swaps with the tile's edge chain (ea, eb), and
// the half-grid phase adds the new main arrays' center sums to v.
template <typename T, bool MAIN>
__device__ __forceinline__ void tile_half_step(
    T* dst_a, T* dst_b, const T* nb_a, const T* nb_b,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost,
    const T* __restrict__ phi, const T* __restrict__ w_av,
    const T* __restrict__ w_av_phi, T cos_t, T cos_t_dt, T ghost_gate,
    const Params<T>& p, const Geometry& g, const Tiling& tl, int col0,
    const Lanes& ln, T* ea, T* eb, T (&v)[SUMS]) {
  const int WT = tl.WT;
  const int m_hi = MAIN ? g.M + 1 : g.M;
  for (int l = ln.l0; l < WT; l += ln.dl) {
    const int la = col0 + l;
    const int mg = tl.base + la;
    const bool in_grid = la >= 0 && la < tl.ld && mg >= 0 && mg < g.MP;
    const T ph = in_grid ? phi[la] : T(0);
    const T mu_col = (p.E_dc + p.E_omega * cos_t + p.B * ph) * p.dt / T(2);
    const T mu1_col =
        (p.E_dc + p.E_omega * cos_t_dt + p.B * ph) * p.dt / T(2);
    const T colf = (mg >= 1 && mg <= m_hi) ? T(1) : T(0);
    const int lp1 = l + 1 == WT ? 0 : l + 1;
    const int lm1 = l == 0 ? WT - 1 : l - 1;
    const bool center = !MAIN && in_grid && l >= tl.H &&
                        l < tl.H + tl.W && la < tl.own_hi;
    for (int n = ln.n0; n < g.NHP; n += ln.dn) {
      const T nf = n < g.N ? T(n) : T(0);
      const T n_ge2 = n >= 2 ? T(1) : T(0);
      const T w_n = n == 0 ? T(0) : (n == 1 ? T(2) : T(1));
      const T nu_a = p.nu * (n < g.N ? T(1) : T(0));
      const T nu_b = nu_a * (n > 0 ? T(1) : T(0));
      const int rp = (n + 1 == g.NHP ? 0 : n + 1) * WT;
      const int rm = (n == 0 ? g.NHP - 1 : n - 1) * WT;
      const int i = n * WT + l;
      const size_t gi = (size_t)n * tl.ld + (in_grid ? la : 0);

      const T a_src = dst_a[i];
      const T b_src = dst_b[i];
      T a_new, b_new;
      slb::cell_update(a_src, b_src, nb_b[rp + lp1] - nb_b[rp + lm1],
                       nb_b[rm + lp1] - nb_b[rm + lm1],
                       nb_a[rp + lp1] - nb_a[rp + lm1],
                       nb_a[rm + lp1] - nb_a[rm + lm1],
                       in_grid ? a0[gi] : T(0), nf * mu_col, nf * mu1_col,
                       nu_a, nu_b, n_ge2, w_n, colf, p, a_new, b_new);
      if (MAIN) {
        // half the steps add nothing: gf = 0 (a + 0 = a)
        if (ghost_gate != T(0) && in_grid)
          a_new = a_new + ghost_gate * a0_ghost[gi];
      } else if (mg == g.M + 1) {
        a_new = ea[n];
        b_new = eb[n];
        ea[n] = a_src;
        eb[n] = b_src;
      }
      dst_a[i] = a_new;
      dst_b[i] = b_new;
      if (center && n < 2) {
        if (n == 0) {
          v[0] += nb_a[i] * w_av[la];             // norm
          v[2] += nb_a[i] * w_av_phi[la];         // v_y
        } else {
          v[1] += nb_b[i] * w_av[la];             // v_dr
          v[3] += nb_a[i] * w_av[la];             // m_x
        }
      }
    }
  }
}

// K (n_steps) full steps of one tile.  The four state arrays in/out and the
// edges in/out are distinct buffers (ping-pong); the working arrays are
// written in one phase and read by other threads in the next, so they
// carry no __restrict__.
template <typename T, bool SMEM>
__global__ void __launch_bounds__(TILE_BLOCK) stream_tile(
    const T* __restrict__ a_in, const T* __restrict__ b_in,
    const T* __restrict__ ahs_in, const T* __restrict__ bhs_in,
    const T* __restrict__ edge_a_in, const T* __restrict__ edge_b_in,
    T* __restrict__ a_out, T* __restrict__ b_out, T* __restrict__ ahs_out,
    T* __restrict__ bhs_out, T* __restrict__ edge_a_out,
    T* __restrict__ edge_b_out, T* scratch, const T* __restrict__ a0,
    const T* __restrict__ a0_ghost, const T* __restrict__ phi,
    const T* __restrict__ w_av, const T* __restrict__ w_av_phi, Params<T> p,
    const T* __restrict__ xs, Geometry g, Tiling tl, int n_steps,
    int parity, T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int WT = tl.WT;
  const int n_cells = g.NHP * WT;
  T* const wa = SMEM ? sm : scratch + (size_t)blockIdx.x * 4 * n_cells;
  T* const wb = wa + n_cells;
  T* const wahs = wb + n_cells;
  T* const wbhs = wahs + n_cells;
  T* const ea = SMEM ? sm + 4 * n_cells : sm;    // the tile's edge chain
  T* const eb = ea + g.NHP;
  const int c0 = tl.own_lo + blockIdx.x * tl.W;  // first center column
  const int col0 = c0 - tl.H;                    // array column of l = 0
  Lanes ln;
  ln.dl = WT < (int)blockDim.x ? WT : (int)blockDim.x;
  ln.dn = blockDim.x / ln.dl;
  ln.l0 = threadIdx.x % ln.dl;
  ln.n0 = (int)threadIdx.x < ln.dl * ln.dn ? threadIdx.x / ln.dl : g.NHP;

  // the extended tile; columns outside the grid start (and stay) finite
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) {
    const int n = i / WT, la = col0 + (i - n * WT), mg = tl.base + la;
    const bool in_grid = la >= 0 && la < tl.ld && mg >= 0 && mg < g.MP;
    const size_t gi = (size_t)n * tl.ld + (in_grid ? la : 0);
    wa[i] = in_grid ? a_in[gi] : T(0);
    wb[i] = in_grid ? b_in[gi] : T(0);
    wahs[i] = in_grid ? ahs_in[gi] : T(0);
    wbhs[i] = in_grid ? bhs_in[gi] : T(0);
  }
  for (int n = threadIdx.x; n < g.NHP; n += blockDim.x) {
    ea[n] = edge_a_in[n];
    eb[n] = edge_b_in[n];
  }
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const T* row = xs + (size_t)s * XS_LANES;
    const T gf = ((s + parity + 1) % 2 == 0) ? T(1) : T(0);
    T v[SUMS] = {T(0), T(0), T(0), T(0)};
    // main half-step in place in wa, wb; then the half grid against the
    // new wa, wb, which that phase only reads (so its sums run there too)
    tile_half_step<T, true>(wa, wb, wahs, wbhs, a0, a0_ghost, phi, w_av,
                            w_av_phi, row[0], row[1], gf, p, g, tl, col0, ln,
                            ea, eb, v);
    __syncthreads();
    tile_half_step<T, false>(wahs, wbhs, wa, wb, a0, a0_ghost, phi, w_av,
                             w_av_phi, row[2], row[3], T(0), p, g, tl, col0,
                             ln, ea, eb, v);
    slb::block_sums<T, SUMS>(v);
    if (threadIdx.x == 0)
      for (int k = 0; k < SUMS; ++k)
        partials[((size_t)s * tl.part_stride + tl.part_off + blockIdx.x) *
                     SUMS + k] = v[k];
    // the next main half-step overwrites wa, wb and reads wahs, wbhs
    __syncthreads();
  }

  for (int i = threadIdx.x; i < g.NHP * tl.W; i += blockDim.x) {
    const int n = i / tl.W, lc = i - n * tl.W, la = c0 + lc;
    if (la < tl.own_hi) {
      const size_t gi = (size_t)n * tl.ld + la, li = (size_t)n * WT + tl.H + lc;
      a_out[gi] = wa[li];
      b_out[gi] = wb[li];
      ahs_out[gi] = wahs[li];
      bhs_out[gi] = wbhs[li];
    }
  }
  const int own_m1 = g.M + 1 - tl.base;          // M+1's array column
  if (c0 <= own_m1 && own_m1 < c0 + tl.W && own_m1 < tl.own_hi)  // owns M+1
    for (int n = threadIdx.x; n < g.NHP; n += blockDim.x) {
      edge_a_out[n] = ea[n];
      edge_b_out[n] = eb[n];
    }
}

// The launch's per-step totals (tile partials added in tile order), the
// av() chain over them and the display-77 records, one block.  carry holds
// the post-step sums of the step before, which are the next step's
// pre-step sums; at the first launch of a chunk (a_pre set) it starts as
// the incoming state's sums.
template <typename T>
__global__ void __launch_bounds__(REPLAY_BLOCK) stream_replay(
    const T* __restrict__ partials, int n_tiles, int n_steps,
    const T* __restrict__ xs, T dt, T* av, T* carry,
    const T* __restrict__ a_pre, const T* __restrict__ b_pre,
    const T* __restrict__ w_av, const T* __restrict__ w_av_phi, int MP,
    T* obs) {
  __shared__ T tot[MAX_K][SUMS];
  const int j = threadIdx.x;
  if (j < n_steps * SUMS) {
    const int s = j / SUMS, k = j - s * SUMS;
    T acc = T(0);
    // unrolled so that the loads run ahead of the adds, which stay in
    // tile order
#pragma unroll 16
    for (int t = 0; t < n_tiles; ++t)
      acc += partials[((size_t)s * n_tiles + t) * SUMS + k];
    tot[s][k] = acc;
  }
  if (a_pre != nullptr) {
    T v[SUMS] = {T(0), T(0), T(0), T(0)};
    for (int m = j; m < MP; m += blockDim.x) {
      v[0] += a_pre[m] * w_av[m];
      v[1] += b_pre[MP + m] * w_av[m];
      v[2] += a_pre[m] * w_av_phi[m];
      v[3] += a_pre[MP + m] * w_av[m];
    }
    slb::block_sums<T, SUMS>(v);
    if (j == 0)
      for (int k = 0; k < SUMS; ++k) carry[k] = v[k];
  }
  __syncthreads();
  if (j != 0) return;
  for (int s = 0; s < n_steps; ++s) {
    const T* row = xs + (size_t)s * XS_LANES;
    if (row[6] > T(0))
      slb::av_chain(av, tot[s][1], tot[s][2], tot[s][3], row[4], row[5], dt);
    if (row[8] > T(0)) {
      T* slot = obs + (size_t)row[9] * OBS_LANES;
      for (int k = 0; k < SUMS; ++k) slot[k] = carry[k];
      slot[4] = row[7];
      for (int k = 0; k < 8; ++k) slot[5 + k] = av[k];
    }
    for (int k = 0; k < SUMS; ++k) carry[k] = tot[s][k];
  }
}

template <typename T>
using TileKernel = decltype(&stream_tile<T, true>);

// stream_tile's instance for a launch over `tl`'s tiles (working tiles in
// shared memory where `smem`, else in the caller's scratch), its dynamic
// shared memory allowed; the bytes a block takes in *smem_bytes.
template <typename T>
cudaError_t tile_kernel(const Tiling& tl, int NHP, bool smem,
                        TileKernel<T>* kern, size_t* smem_bytes) {
  *smem_bytes = ((smem ? 4 * (size_t)NHP * tl.WT : 0) + 2 * NHP) * sizeof(T);
  *kern = smem ? stream_tile<T, true> : stream_tile<T, false>;
  return cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem_bytes);
}

template <typename T>
int stream_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
                 const T* a0, const T* a0_ghost, const T* phi,
                 const T* w_av, const T* w_av_phi, const T* params,
                 const T* xs, T* obs, T* alt, T* scratch, T* partials,
                 T* carry, int N, int M, int NHP, int MP, int K, int W,
                 int H, int n_steps, int parity0, void* stream) {
  if (K < 1 || K > MAX_K || 2 * K > H || W < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params<T> p = {params[0], params[1], params[2], params[3],
                       params[4], params[5], params[6], params[7],
                       params[8], params[9], params[10]};
  const Geometry g = {N, M, NHP, MP};
  const int n_tiles = (MP + W - 1) / W;
  const Tiling tl = {W, H, W + 2 * H, n_tiles, MP, 0, 0, MP, 0, n_tiles};
  TileKernel<T> kern;
  size_t smem_bytes;
  cudaError_t err = tile_kernel<T>(tl, NHP, scratch == nullptr, &kern,
                                   &smem_bytes);
  if (err != cudaSuccess) return (int)err;

  const size_t plane = (size_t)NHP * MP;
  T* cur[6] = {a, b, a_hs, b_hs, edge_a, edge_b};
  T* oth[6] = {alt, alt + plane, alt + 2 * plane, alt + 3 * plane,
               alt + 4 * plane, alt + 4 * plane + NHP};
  int launch = 0;
  for (int s0 = 0; s0 < n_steps; s0 += K, ++launch) {
    const int ns = n_steps - s0 < K ? n_steps - s0 : K;
    T* const* src = launch % 2 == 0 ? cur : oth;
    T* const* dst = launch % 2 == 0 ? oth : cur;
    const T* x = xs + (size_t)s0 * XS_LANES;
    kern<<<tl.n_tiles, TILE_BLOCK, smem_bytes, st>>>(
        src[0], src[1], src[2], src[3], src[4], src[5], dst[0], dst[1],
        dst[2], dst[3], dst[4], dst[5], scratch, a0, a0_ghost, phi, w_av,
        w_av_phi, p, x, g, tl, ns, (parity0 + s0) % 2, partials);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    stream_replay<T><<<1, REPLAY_BLOCK, 0, st>>>(
        partials, tl.n_tiles, ns, x, p.dt, av, carry,
        launch == 0 ? src[0] : nullptr, launch == 0 ? src[1] : nullptr, w_av,
        w_av_phi, MP, obs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (launch % 2 == 1)            // the result is in the second set
    for (int k = 0; k < 6; ++k) {
      err = cudaMemcpyAsync(cur[k], oth[k], (k < 4 ? plane : NHP) * sizeof(T),
                            cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
    }
  return 0;
}

// ---- the sharded tiling form --------------------------------------------

// One launch of the tiling form over a shard's extended slice (ld = L + 2H
// columns a row, its halo columns filled from the neighbouring shards by
// the host), src to dst, n_steps <= MAX_K steps; the tiles' step sums go to
// partials columns part_off.. of a (n_steps, part_stride, 4) table that
// the replay below reads for every shard at once.
template <typename T>
int shard_tiles(const T* a_in, const T* b_in, const T* ahs_in,
                const T* bhs_in, const T* ea_in, const T* eb_in, T* a_out,
                T* b_out, T* ahs_out, T* bhs_out, T* ea_out, T* eb_out,
                T* scratch, const T* a0, const T* a0_ghost, const T* phi,
                const T* w_av, const T* w_av_phi, const T* params,
                const T* xs, T* partials, int N, int M, int NHP, int MP,
                int ld, int base, int own_lo, int own_hi, int W, int H,
                int n_steps, int parity, int part_off, int part_stride,
                void* stream) {
  if (n_steps < 1 || n_steps > MAX_K || 2 * n_steps > H || W < 1 ||
      own_lo < H || own_hi + H > ld || own_hi <= own_lo)
    return (int)cudaErrorInvalidValue;
  const Params<T> p = {params[0], params[1], params[2], params[3],
                       params[4], params[5], params[6], params[7],
                       params[8], params[9], params[10]};
  const Geometry g = {N, M, NHP, MP};
  const int n_tiles = (own_hi - own_lo + W - 1) / W;
  const Tiling tl = {W,  H,      W + 2 * H, n_tiles,  ld,
                     base, own_lo, own_hi,  part_off, part_stride};
  TileKernel<T> kern;
  size_t smem_bytes;
  cudaError_t err = tile_kernel<T>(tl, NHP, scratch == nullptr, &kern,
                                   &smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<n_tiles, TILE_BLOCK, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      a_in, b_in, ahs_in, bhs_in, ea_in, eb_in, a_out, b_out, ahs_out,
      bhs_out, ea_out, eb_out, scratch, a0, a0_ghost, phi, w_av, w_av_phi, p,
      xs, g, tl, n_steps, parity, partials);
  return (int)cudaGetLastError();
}

// The replay of one launch round over every shard's tile sums (added in
// partials' column order: shard by shard, tile by tile), from the pre-step
// sums in carry, which the host sets at a chunk's start.
template <typename T>
int shard_replay(const T* partials, const T* xs, const T* params, T* av,
                 T* carry, T* obs, int n_tiles, int n_steps, void* stream) {
  if (n_steps < 1 || n_steps > MAX_K || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  stream_replay<T><<<1, REPLAY_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_tiles, n_steps, xs, params[4], av, carry, nullptr, nullptr,
      nullptr, nullptr, 0, obs);
  return (int)cudaGetLastError();
}

// ---- the spill form ----------------------------------------------------

// The spill form: spill_band_chunk (band_step.cuh), one block per band,
// bands of MP / bands columns (the first MP % bands one more), R of them
// resident.
template <typename T>
__global__ void __launch_bounds__(slb::RESIDENT_BLOCK, 1)
    spill_chunk(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
                const T* __restrict__ a0, const T* __restrict__ a0_ghost,
                const T* __restrict__ phi, const T* __restrict__ w_av,
                const T* __restrict__ w_av_phi, const T* __restrict__ xs,
                T* obs, T* xch, T* part, Params<T> p, Geometry g, int R,
                int n_steps, int parity0, T* slab, long long* tally) {
  slb::spill_band_chunk<T>(a, b, a_hs, b_hs, edge_a, edge_b, av, a0,
                           a0_ghost, phi, w_av, w_av_phi, xs, obs, xch, part,
                           p, g, R, n_steps, parity0, slab, tally);
}

template <typename T>
size_t spill_smem_bytes(int NHP, int R) {
  return slb::resident_smem_bytes<T>(NHP, R) + slb::SPILL_SUMS * sizeof(T);
}

// cudaSuccess, or why `bands` bands with R resident columns cannot hold an
// (NHP, MP) state: R not a multiple of BAND_ALIGN up to MAX_BAND, fewer
// than 2 rows, a band's spill narrower than HALO_HALF or wider than
// MAX_SPILL, or the resident part, the row sums' scratch and the spill
// sums past SMEM_LIMIT
template <typename T>
cudaError_t check_spill(int R, int bands, int NHP, int MP) {
  using namespace slb;
  if (R < BAND_ALIGN || R > MAX_BAND || R % BAND_ALIGN != 0 || NHP < 2 ||
      bands < 1 || MP / bands - R < HALO_HALF ||
      (MP + bands - 1) / bands - R > MAX_SPILL)
    return cudaErrorInvalidValue;
  if (spill_smem_bytes<T>(NHP, R) + RESIDENT_SCRATCH * sizeof(T) >
      (size_t)SMEM_LIMIT)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The spill form's launch shape: the kernel's shared-memory attribute
// set, and the blocks the card runs at once
template <typename T>
cudaError_t spill_config(int R, int bands, int NHP, int MP, int* at_once) {
  cudaError_t err = check_spill<T>(R, bands, NHP, MP);
  if (err != cudaSuccess) return err;
  const int smem = (int)spill_smem_bytes<T>(NHP, R);
  const auto kern = spill_chunk<T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, slb::resident_threads(R), smem)) != cudaSuccess)
    return err;
  *at_once = per_sm * sms;
  return cudaSuccess;
}

// One cooperative launch of the spill form.
template <typename T>
int run_spill(T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
              const T* a0, const T* a0_ghost, const T* phi, const T* w_av,
              const T* w_av_phi, const T* params, const T* xs, T* obs,
              T* xch, T* part, T* slab, long long* tally, int N, int M,
              int NHP, int MP, int R, int bands, int n_steps, int parity0,
              void* stream) {
  Params<T> p = {params[0], params[1], params[2], params[3],
                 params[4], params[5], params[6], params[7],
                 params[8], params[9], params[10]};
  Geometry g = {N, M, NHP, MP};
  int at_once = 0;
  cudaError_t err = spill_config<T>(R, bands, NHP, MP, &at_once);
  if (err != cudaSuccess) return (int)err;
  if (at_once < bands) return slb::NOT_CO_RESIDENT;
  void* args[] = {&a,   &b,       &a_hs,     &b_hs, &edge_a, &edge_b,
                  &av,  &a0,      &a0_ghost, &phi,  &w_av,   &w_av_phi,
                  &xs,  &obs,     &xch,      &part, &p,      &g,
                  &R,   &n_steps, &parity0,  &slab, &tally};
  err = cudaLaunchCooperativeKernel(
      (const void*)spill_chunk<T>, dim3(bands),
      dim3(slb::resident_threads(R)), args, spill_smem_bytes<T>(NHP, R),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the spill form takes on this card: out[0] registers a thread,
// out[1] local (spill) bytes a thread, out[2] dynamic shared memory a
// block, out[3] blocks that run at once on the whole card, out[4] threads
// a block, out[5] static shared memory a block
template <typename T>
int spill_info(int R, int bands, int NHP, int MP, int* out) {
  int at_once = 0;
  cudaError_t err = spill_config<T>(R, bands, NHP, MP, &at_once);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, spill_chunk<T>)) != cudaSuccess)
    return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)spill_smem_bytes<T>(NHP, R);
  out[3] = at_once;
  out[4] = slb::resident_threads(R);
  out[5] = (int)fa.sharedSizeBytes;
  return 0;
}

}  // namespace

// C entry points (bound with ctypes in ops/stepper_stream_cuda.py).  Every
// array pointer is a device pointer except `params` (16 host values in
// SCALAR_FIELDS order).  alt is the second buffer set (4·NHP·MP + 2·NHP
// values); scratch is the per-block working memory (n_tiles·4·NHP·(W+2H)
// values), or null to keep the working tiles in shared memory; partials
// holds K·n_tiles·4 values, carry 4.  They enqueue two launches per K steps
// (the tiles, the replay) and at most six copies on `stream`, do not
// synchronise, and return 0 or the first cudaError_t.
#define SLB_STREAM_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                       \
      void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,  \
      void* av, const void* a0, const void* a0_ghost, const void* phi,       \
      const void* w_av, const void* w_av_phi, const void* params,            \
      const void* xs, void* obs, void* alt, void* scratch, void* partials,   \
      void* carry, int N, int M, int NHP, int MP, int K, int W, int H,       \
      int n_steps, int parity0, void* stream) {                              \
    return stream_chunk<T>(                                                  \
        (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,    \
        (const T*)a0, (const T*)a0_ghost, (const T*)phi, (const T*)w_av,     \
        (const T*)w_av_phi, (const T*)params, (const T*)xs, (T*)obs,         \
        (T*)alt, (T*)scratch, (T*)partials, (T*)carry, N, M, NHP, MP, K, W,  \
        H, n_steps, parity0, stream);                                        \
  }

SLB_STREAM_ENTRY(slb_stream_chunk_f32, float)
SLB_STREAM_ENTRY(slb_stream_chunk_f64, double)

// The sharded tiling form's entry points (parallel/stream_shard.py
// ShardedStreamRunner): slb_stream_shard_tiles_* enqueues shard_tiles'
// one launch, slb_stream_replay_* shard_replay's; device pointers except
// `params` (16 host values); they do not synchronise and return 0 or the
// first cudaError_t (cudaErrorInvalidValue for a geometry they cannot
// run).
#define SLB_SHARD_ENTRIES(TILES, REPLAY, T)                                   \
  extern "C" int TILES(                                                      \
      const void* a_in, const void* b_in, const void* ahs_in,                \
      const void* bhs_in, const void* ea_in, const void* eb_in, void* a_out, \
      void* b_out, void* ahs_out, void* bhs_out, void* ea_out, void* eb_out, \
      void* scratch, const void* a0, const void* a0_ghost, const void* phi,  \
      const void* w_av, const void* w_av_phi, const void* params,            \
      const void* xs, void* partials, int N, int M, int NHP, int MP, int ld, \
      int base, int own_lo, int own_hi, int W, int H, int n_steps,           \
      int parity, int part_off, int part_stride, void* stream) {             \
    return shard_tiles<T>(                                                   \
        (const T*)a_in, (const T*)b_in, (const T*)ahs_in, (const T*)bhs_in,  \
        (const T*)ea_in, (const T*)eb_in, (T*)a_out, (T*)b_out,              \
        (T*)ahs_out, (T*)bhs_out, (T*)ea_out, (T*)eb_out, (T*)scratch,       \
        (const T*)a0, (const T*)a0_ghost, (const T*)phi, (const T*)w_av,     \
        (const T*)w_av_phi, (const T*)params, (const T*)xs, (T*)partials, N, \
        M, NHP, MP, ld, base, own_lo, own_hi, W, H, n_steps, parity,         \
        part_off, part_stride, stream);                                      \
  }                                                                          \
  extern "C" int REPLAY(const void* partials, const void* xs,                \
                        const void* params, void* av, void* carry, void* obs, \
                        int n_tiles, int n_steps, void* stream) {            \
    return shard_replay<T>((const T*)partials, (const T*)xs,                 \
                           (const T*)params, (T*)av, (T*)carry, (T*)obs,     \
                           n_tiles, n_steps, stream);                        \
  }

SLB_SHARD_ENTRIES(slb_stream_shard_tiles_f32, slb_stream_replay_f32, float)
SLB_SHARD_ENTRIES(slb_stream_shard_tiles_f64, slb_stream_replay_f64, double)

// The spill form's entry points: the arguments of slb_resident_chunk_*
// (stepper.cu) with the bands' slabs (bands x NHP x (2 (Smax + 2) +
// 2 (Smax + 4)) values, Smax = ceil(MP / bands) - R; device scratch) and
// their tally (SPILL_TALLY x bands int64 words, which each launch
// overwrites: a band's step-loop cycles and its cycles inside the grid
// barrier), the resident columns R of a band and the bands (blocks; at
// most the SMs).
// They enqueue ONE cooperative launch on `stream`, do not synchronise, and return 0,
// the cudaError_t of a refused launch (cudaErrorInvalidValue for a plan
// that cannot hold the state), or NOT_CO_RESIDENT; a refused launch
// changes nothing.
#define SLB_SPILL_ENTRY(NAME, T)                                             \
  extern "C" int NAME(                                                       \
      void* a, void* b, void* a_hs, void* b_hs, void* edge_a, void* edge_b,  \
      void* av, const void* a0, const void* a0_ghost, const void* phi,       \
      const void* w_av, const void* w_av_phi, const void* params,            \
      const void* xs, void* obs, void* xch, void* part, void* slab,          \
      void* tally, int N, int M, int NHP, int MP, int R, int bands,          \
      int n_steps, int parity0, void* stream) {                              \
    return run_spill<T>(                                                     \
        (T*)a, (T*)b, (T*)a_hs, (T*)b_hs, (T*)edge_a, (T*)edge_b, (T*)av,    \
        (const T*)a0, (const T*)a0_ghost, (const T*)phi, (const T*)w_av,     \
        (const T*)w_av_phi, (const T*)params, (const T*)xs, (T*)obs,         \
        (T*)xch, (T*)part, (T*)slab, (long long*)tally, N, M, NHP, MP, R,    \
        bands, n_steps, parity0, stream);                                    \
  }

SLB_SPILL_ENTRY(slb_stream_spill_chunk_f32, float)
SLB_SPILL_ENTRY(slb_stream_spill_chunk_f64, double)

// spill_info for float or double; returns 0 or the cudaError_t of the
// query (cudaErrorInvalidValue for a plan that cannot hold the state)
extern "C" int slb_stream_spill_info(int f64, int R, int bands, int NHP,
                                     int MP, int* out) {
  return f64 ? spill_info<double>(R, bands, NHP, MP, out)
             : spill_info<float>(R, bands, NHP, MP, out);
}
