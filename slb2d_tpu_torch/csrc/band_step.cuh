// The band loops of the resident step kernels: B1's resident form
// (stepper.cu: resident_chunk; resident_band_chunk below) and B2's spill
// form (stepper_stream.cu: spill_chunk; spill_band_chunk below).  Both are
// one cooperative launch per chunk, one block per SM, each block holding a
// band of columns of a, b, a_hs and b_hs for the whole chunk; they share
// the cell code, the halo exchange's layout and the sums, and keep their
// own step order: the spill form runs the two half-steps in order with one
// grid barrier a step (cooperative groups), B1's resident form splits the
// step around a barrier of its own, arriving once its edge columns are out
// and waiting only where it next needs its halo (resident_band_chunk's
// notes).
//
// Resident part (both forms): the band's first W columns in dynamic
// shared memory, a, b with HALO_MAIN columns on each side (row stride
// SA = W + 2), a_hs, b_hs with HALO_HALF (SH = W + 4).  Row neighbours,
// the row wrap included, are the band's own rows; only the m±1 halo
// crosses bands: the band runs the main half-step on its columns AND on
// its one a, b halo column on each side (what the neighbour computes as
// its own, from the same inputs, so the same bits), then the half-grid
// half-step on its columns, publishing its first two and last two columns
// of a_hs, b_hs to the exchange buffer xch; after the grid barrier it
// reads its neighbours' into its a_hs, b_hs halo.  See stepper.cu's notes
// for the sums, the av chain and the records.
//
// Spill part (the spill form): where the card's shared memory cannot hold
// the state, block k's band is [c0, c0 + Wk) with Wk = floor or ceil of
// MP / bands, its first W columns resident as above and the other
// Sk = Wk - W >= 2 in a slab of device memory with the same layout (a, b
// rows of Smax + 2 values, a_hs, b_hs rows of Smax + 4, Smax the widest
// band's spill), which stays in L2.  The slab is a second band of the same
// block, stepped by the same functions on global pointers: its own a, b
// halo columns computed (global c0 + W - 1 and c0 + Wk), its a_hs, b_hs
// halo copied in the block after the grid barrier (left: the resident
// part's last two columns; right: the right band's first two, from xch),
// and the resident part's right a_hs, b_hs halo is the slab's first two
// columns.  The band publishes its first two columns from shared memory
// and its last two from the slab.  A thread's spill cells are column
// t % Sk, rows t / Sk, t / Sk + blockDim / Sk, ... (a warp on neighbouring
// columns of a row: the loads coalesce), stepped after its resident rows
// (one spill cell before every fourth resident row instead was 2-3%
// slower at N=100 M=20000 on an H100).  The slab's rows 0 and 1 add to
// the band's partial sums after the resident columns.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "half_step.cuh"

namespace slb {

namespace cg = cooperative_groups;

constexpr int OBS_LANES = 16;

// The resident forms' budget (ops/stepper_cuda.py resident_plan and
// ops/stepper_stream_cuda.py spill_plan mirror these;
// tests/test_torch_stepper_resident.py and tests/test_torch_stream_spill.py
// hold them to each other): a block's opt-in shared memory on an H100;
// the halo columns on each side of a band's a, b (the band computes their
// main half-step itself) and of its a_hs, b_hs (exchanged; the halo
// cells' main half-step reads them); the xs rows staged at a time (plus
// the next); the band width's unit (a warp's lanes on neighbouring
// columns) and its largest value (two row groups at least, so rows 0 and
// 1 lie in different warps), the largest block, and the static scratch of
// the row sums (elements: 2 rows x MAX_BAND / BAND_ALIGN warps x 2
// values).
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
// the steps of partials B1's resident form keeps (its head adds a step's
// partials after the next step's arrival: resident_band_chunk), and the
// words of its barrier before the bands' tallies (the counter, the blocks
// that have left)
constexpr int PART_SLOTS = 3;
constexpr int SYNC_WORDS = 2;
// returned when the card cannot run every band's block at once
constexpr int NOT_CO_RESIDENT = -2;
// The spill part's budget: the widest spill a band may have, and the
// products of its rows 0 and 1 (2 rows x MAX_SPILL columns x 2 values,
// dynamic shared memory after the xs rows)
constexpr int MAX_SPILL = 128;
constexpr int SPILL_SUMS = 2 * MAX_SPILL * 2;
// the int64 words of a band's tally in the spill form (spill_band_chunk):
// its step loop's cycles, then its cycles inside the grid barrier
constexpr int SPILL_TALLY = 2;
// the int64 words of a band's cycle tally in B1's resident form
// (resident_band_chunk): its step loop's cycles, then its exposed cycles
constexpr int B1_TALLY = 2;

template <typename T>
size_t resident_smem_bytes(int NHP, int W) {
  return ((size_t)2 * NHP * (W + 2 * HALO_MAIN) +
          (size_t)2 * NHP * (W + 2 * HALO_HALF) +
          (size_t)(XS_STAGE + 1) * XS_LANES) * sizeof(T);
}

// threads of a block with bands of W columns: W / 32 warps across the
// band times 32 / (W / 32) row groups
inline int resident_threads(int W) {
  const int cw = W / BAND_ALIGN;
  return BAND_ALIGN * cw * (RESIDENT_BLOCK / BAND_ALIGN / cw);
}

// What a thread owns in a band part: band-local column j (global column
// m) in rows r0, r0 + RW, ... of a part of Wb columns, the column's terms,
// and where it publishes its a_hs, b_hs (the offset of its column in the
// band's exchange slot, or -1: only the band's first two and last two
// columns publish).
template <typename T>
struct Lane {
  int r0, RW, j, m, pub;
  bool live, ghost_col, edge_col;
  T ph, colf_main, colf_half;
};

// A load of a band part's array: in shared memory a plain load; in the
// slab (GL) an explicit ld.global.ca, so that the compiler never takes the
// read-only path for data the block writes during the kernel (L1 serves
// the block's own writes: the slab is one block's).
template <typename T, bool GL>
__device__ __forceinline__ T band_ld(const T* p, int i) {
  if constexpr (GL)
    return __ldca(p + i);
  else
    return p[i];
}

// One cell's stencil in a band part: the pair it advances (dA, dB) at
// offset od, the other pair (nA, nB, row stride Sn) at offset on, which is
// the cell's column in row n.  INTERIOR: rows 2 <= n < N, where the row
// terms are constants, n±1 never wrap and nf (= n) comes from the caller;
// else every term as half_step_cell computes it, the row wrap included.
// The same operands in the same order as half_step_cell, so the same bits.
// GL: the part is the slab.
template <typename T, bool INTERIOR, bool GL = false>
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
  const T dmb_p = band_ld<T, GL>(nB, on + up + 1) -
                  band_ld<T, GL>(nB, on + up - 1);
  const T dmb_m = band_ld<T, GL>(nB, on + dn + 1) -
                  band_ld<T, GL>(nB, on + dn - 1);
  const T dma_p = band_ld<T, GL>(nA, on + up + 1) -
                  band_ld<T, GL>(nA, on + up - 1);
  const T dma_m = band_ld<T, GL>(nA, on + dn + 1) -
                  band_ld<T, GL>(nA, on + dn - 1);
  a_src = band_ld<T, GL>(dA, od);
  b_src = band_ld<T, GL>(dB, od);
  slb::cell_update(a_src, b_src, dmb_p, dmb_m, dma_p, dma_m, a0v,
                   nf * cp_t, nf * cp_t1, nu_a, nu_b, n_ge2, w_n, colf, p,
                   a_new, b_new);
}

// The thread's cell in row n: band_cell, then (MAIN) the ghost fill --
// a0_ghost is 0 in the interior (models/superlattice.py), so the fill adds
// gf · 0 there, as the plain version does -- or (half grid) the edge swap
// at column M+1 and the publication of the band's edge columns.  dst is
// updated in place: a cell reads dst only at its own (n, m), every
// neighbour from the other pair, which no thread writes in this phase.
// GL: the part is the slab.  B1 (B1's resident form): the loads the cell
// ends with (the ghost value, the carried edge) are issued before the
// cell, so that their latency runs under its arithmetic.
template <typename T, bool MAIN, bool INTERIOR, bool GL = false,
          bool B1 = false>
__device__ __forceinline__ void own_cell(
    T* __restrict__ dA, T* __restrict__ dB, const T* __restrict__ nA,
    const T* __restrict__ nB, int od, int on, int Sn, int n, T nf, int gi,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost,
    T* __restrict__ edge_a, T* __restrict__ edge_b, T* __restrict__ pub,
    T cp_t, T cp_t1, T colf, T gf, const Params<T>& p, const Geometry& g,
    const Lane<T>& L) {
  const bool ghost = MAIN && (L.ghost_col || (!INTERIOR && n >= g.N));
  T gv = T(0), ea = T(0), eb = T(0);
  if constexpr (B1) {
    if (ghost) gv = __ldg(a0_ghost + gi);
    if (!MAIN && L.edge_col) {
      ea = edge_a[n];
      eb = edge_b[n];
    }
  }
  T a_src, b_src, a_new, b_new;
  band_cell<T, INTERIOR, GL>(dA, dB, nA, nB, od, on, Sn, n, g.NHP, g.N, nf,
                             cp_t, cp_t1, colf, __ldg(a0 + gi), p, a_src,
                             b_src, a_new, b_new);
  if (MAIN) {
    if constexpr (!B1)
      if (ghost) gv = __ldg(a0_ghost + gi);
    a_new = a_new + gf * (ghost ? gv : T(0));
  } else if (L.edge_col) {
    if constexpr (!B1) {
      ea = edge_a[n];
      eb = edge_b[n];
    }
    a_new = ea;
    b_new = eb;
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

// The slab's side of one half-step (band_half_step with SPILL): the pair
// it advances (dA, dB, row stride Sd) and the other pair (nA, nB, row
// stride Sn), where it publishes, the column terms of its lane L.
template <typename T>
struct SlabPart {
  T *dA, *dB;
  const T *nA, *nB;
  int Sd, Sn;
  T* pub;
  T cp_t, cp_t1, colf;
  const Lane<T>* L;
};

// The thread's next spill cell (row sn, offsets sod, son, sgi) of one
// half-step by the general cell, and the cursor moved to the one after.
template <typename T, bool MAIN>
__device__ __forceinline__ void spill_cell(
    const SlabPart<T>& sp, int& sn, int& sod, int& son, int& sgi,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost, T* edge_a,
    T* edge_b, T gf, const Params<T>& p, const Geometry& g) {
  const Lane<T>& Ls = *sp.L;
  own_cell<T, MAIN, false, true>(sp.dA, sp.dB, sp.nA, sp.nB, sod, son, sp.Sn,
                                 sn, T(0), sgi, a0, a0_ghost, edge_a, edge_b,
                                 sp.pub, sp.cp_t, sp.cp_t1, sp.colf, gf, p, g,
                                 Ls);
  sn += Ls.RW;
  sod += Ls.RW * sp.Sd;
  son += Ls.RW * sp.Sn;
  sgi += Ls.RW * g.MP;
}

// One half-step over the thread's cells of a band part (MAIN: the main
// grid, dst a, b and nb a_hs, b_hs; else the half grid, the other way
// round); Sd, hd and Sn, hn: the row stride and halo width of the dst and
// nb pair.  Rows 0 and 1 and rows >= N take the general cell, the rest
// the interior one; a thread's rows ascend, so these are three runs.
// SPILL: the thread's cells of the slab too (sp), each by the general
// cell, after the resident rows.  B1: own_cell's.
template <typename T, bool MAIN, bool SPILL = false, bool B1 = false>
__device__ __forceinline__ void band_half_step(
    T* dA, T* dB, const T* nA, const T* nB, int Sd, int hd, int Sn, int hn,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost, T* edge_a,
    T* edge_b, T* pub, T cp_t, T cp_t1, T colf, T gf, const Params<T>& p,
    const Geometry& g, const Lane<T>& L, const SlabPart<T>* sp = nullptr) {
  // the thread's next spill cell (SPILL)
  int sn = 0, sod = 0, son = 0, sgi = 0;
  if constexpr (SPILL) {
    const Lane<T>& Ls = *sp->L;
    sn = Ls.live ? Ls.r0 : g.NHP;
    sod = sn * sp->Sd + Ls.j + hd;
    son = sn * sp->Sn + Ls.j + hn;
    sgi = sn * g.MP + Ls.m;
  }
  if (L.live) {
    const int RW = L.RW, dd = RW * Sd, dnb = RW * Sn, dg = RW * g.MP;
    int n = L.r0;
    int od = n * Sd + L.j + hd, on = n * Sn + L.j + hn, gi = n * g.MP + L.m;
    if (n < 2) {
      own_cell<T, MAIN, false, false, B1>(
          dA, dB, nA, nB, od, on, Sn, n, T(0), gi, a0, a0_ghost, edge_a,
          edge_b, pub, cp_t, cp_t1, colf, gf, p, g, L);
      n += RW;
      od += dd;
      on += dnb;
      gi += dg;
    }
    T nf = T(n);
    for (; n < g.N; n += RW, od += dd, on += dnb, gi += dg, nf += T(RW))
      own_cell<T, MAIN, true, false, B1>(
          dA, dB, nA, nB, od, on, Sn, n, nf, gi, a0, a0_ghost, edge_a,
          edge_b, pub, cp_t, cp_t1, colf, gf, p, g, L);
    for (; n < g.NHP; n += RW, od += dd, on += dnb, gi += dg)
      own_cell<T, MAIN, false, false, B1>(
          dA, dB, nA, nB, od, on, Sn, n, T(0), gi, a0, a0_ghost, edge_a,
          edge_b, pub, cp_t, cp_t1, colf, gf, p, g, L);
  }
  if constexpr (SPILL)
    while (sn < g.NHP)
      spill_cell<T, MAIN>(*sp, sn, sod, son, sgi, a0, a0_ghost, edge_a,
                          edge_b, gf, p, g);
}

// The main half-step on a band part's two a, b halo columns (local -1
// and Wb, global c0 - 1 and c0 + Wb with the column wrap), which the
// neighbours compute as their own: the same inputs (a_hs, b_hs two
// columns deep), so the same bits, and no exchange of a, b.  SLAB: the
// part is the slab, and the block's last threads take its cells (the
// resident part's take the first).
template <typename T, bool SLAB = false>
__device__ __forceinline__ void halo_cells(
    T* sA, T* sB, const T* sAh, const T* sBh, int SA, int SH, int c0, int Wb,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost,
    const T* __restrict__ phi, T cos_t, T cos_t_dt, T gf, const Params<T>& p,
    const Geometry& g) {
  const int NHP = g.NHP, MP = g.MP;
  int t = threadIdx.x;
  if constexpr (SLAB) t = blockDim.x - 1 - threadIdx.x;
  for (int k = t; k < 2 * NHP; k += blockDim.x) {
    const bool right = k >= NHP;
    const int n = right ? k - NHP : k;
    const int c = right ? Wb : -1;
    int col = c0 + c;
    col = col < 0 ? col + MP : (col >= MP ? col - MP : col);
    const T ph = __ldg(phi + col);
    const int gi = n * MP + col;
    const int od = n * SA + c + HALO_MAIN;
    T a_src, b_src, a_new, b_new;
    band_cell<T, false, SLAB>(sA, sB, sAh, sBh, od, n * SH + c + HALO_HALF,
                              SH, n, NHP, g.N, T(0),
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
// publishing band.  Read past L1 (other SMs wrote them).  SPILL: the right
// band's first two go to the slab's right halo (gAh, gBh, row stride GH,
// columns Sk, Sk + 1), and the block copies its resident part's last two
// columns into the slab's left halo and the slab's first two into the
// resident part's right halo (columns Wb, Wb + 1).
template <typename T, bool SPILL = false>
__device__ __forceinline__ void fill_halo(T* sAh, T* sBh, const T* x,
                                          int left, int right, int NHP,
                                          int SH, int Wb, T* gAh = nullptr,
                                          T* gBh = nullptr, int GH = 0,
                                          int Sk = 0) {
  const size_t slot = (size_t)XCH_LANES * NHP;
  for (int k = threadIdx.x; k < XCH_LANES * NHP; k += blockDim.x) {
    const int q = k / NHP, n = k - q * NHP;
    const int arr = q & 1, which = (q >> 1) & 1, side = q >> 2;
    const int c = side ? which - 2 : Wb + which;
    const T v = __ldcg(x + (side ? left : right) * slot + k);
    if constexpr (SPILL) {
      if (!side) {
        (arr ? gBh : gAh)[n * GH + Sk + which + HALO_HALF] = v;
        continue;
      }
    }
    (arr ? sBh : sAh)[n * SH + c + HALO_HALF] = v;
  }
  if constexpr (SPILL)
    for (int k = threadIdx.x; k < XCH_LANES * NHP; k += blockDim.x) {
      const int q = k / NHP, n = k - q * NHP;
      const int arr = q & 1, which = (q >> 1) & 1, to_slab = q >> 2;
      T* const s = (arr ? sBh : sAh) + n * SH + HALO_HALF;
      T* const gs = (arr ? gBh : gAh) + n * GH + HALO_HALF;
      if (to_slab)
        gs[which - 2] = s[Wb - 2 + which];
      else
        s[Wb + which] = gs[which];
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

// The slab's rows 0 and 1: each of their cells' two products (row_sums'
// x, y) into ss[row][column][2], by the thread that wrote the cell.
template <typename T>
__device__ __forceinline__ void spill_products(T* ss, const T* gA,
                                               const T* gB, int GA,
                                               const T* __restrict__ w_av,
                                               const T* __restrict__ w_av_phi,
                                               const Lane<T>& Ls) {
  if (!Ls.live || Ls.r0 >= 2) return;
  const int o = Ls.r0 * GA + Ls.j + HALO_MAIN;
  const T w = __ldg(w_av + Ls.m);
  T* const out = ss + (Ls.r0 * MAX_SPILL + Ls.j) * 2;
  if (Ls.r0 == 0) {
    out[0] = gA[o] * w;
    out[1] = gA[o] * __ldg(w_av_phi + Ls.m);
  } else {
    out[0] = gB[o] * w;
    out[1] = gA[o] * w;
  }
}

// The band's partials from the warps' sums, in column-group order, to its
// slot of part (thread 0, after a block barrier).  SPILL: the slab's
// sums (extra: norm, v_dr, v_y, m_x) added after them.
template <typename T, bool SPILL = false>
__device__ __forceinline__ void band_partials(T (&sums)[2][SUM_WARPS][2],
                                              int cw, T* part,
                                              const T* extra = nullptr) {
  T s[PART_LANES] = {T(0), T(0), T(0), T(0)};
  for (int c = 0; c < cw; ++c) {
    s[0] += sums[0][c][0];   // norm
    s[1] += sums[1][c][0];   // v_dr
    s[2] += sums[0][c][1];   // v_y
    s[3] += sums[1][c][1];   // m_x
  }
  if constexpr (SPILL)
    for (int q = 0; q < PART_LANES; ++q) s[q] += extra[q];
  for (int q = 0; q < PART_LANES; ++q) __stcg(part + q, s[q]);
}

// The slab's sums from spill_products' table, by one warp (after a block
// barrier): lane l the columns l, l+32, ... in order, then warp_sum's
// shuffle tree.  Valid in lane 0, in band_partials' lane order.
template <typename T>
__device__ __forceinline__ void spill_sums(const T* ss, int Sk,
                                           T (&out)[PART_LANES]) {
  T s[PART_LANES] = {T(0), T(0), T(0), T(0)};
  for (int j = threadIdx.x & 31; j < Sk; j += 32) {
    s[0] += ss[j * 2];                       // norm
    s[1] += ss[(MAX_SPILL + j) * 2];         // v_dr
    s[2] += ss[j * 2 + 1];                   // v_y
    s[3] += ss[(MAX_SPILL + j) * 2 + 1];     // m_x
  }
  for (int q = 0; q < PART_LANES; ++q) out[q] = slb::warp_sum(s[q]);
}

// The spill form's band partials: the slab's sums by warp 0 (after a
// block barrier), added after the warps' sums by its lane 0.
template <typename T>
__device__ __forceinline__ void spill_partials(T (&sums)[2][SUM_WARPS][2],
                                               int cw, const T* ss, int Sk,
                                               T* part) {
  if (threadIdx.x >= 32) return;
  T extra[PART_LANES];
  spill_sums(ss, Sk, extra);
  if (threadIdx.x == 0) band_partials<T, true>(sums, cw, part, extra);
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

// The thread's lane of a band's resident part (columns [c0, c0 + Wb), W / 32
// = cw warps across it): column j = (warp % cw)·32 + lane, rows r0 = warp /
// cw, r0 + RW, ...; publish: the band's first two columns publish from
// their lanes (the spill form; B1's resident form publishes from
// edge_cells).
template <typename T>
__device__ __forceinline__ Lane<T> band_lane(int c0, int Wb, int cw,
                                             bool publish,
                                             const T* __restrict__ phi,
                                             const Geometry& g) {
  const int warp = threadIdx.x >> 5;
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
  L.pub = publish && L.live && L.j < 2 ? L.j * 2 * g.NHP : -1;
  return L;
}

// A band's resident part and its halo columns from the state (the column
// wrap of the plain version), and its part back to the state.
template <typename T>
__device__ __forceinline__ void load_band(T* sA, T* sB, T* sAh, T* sBh,
                                          const T* a, const T* b,
                                          const T* a_hs, const T* b_hs,
                                          int c0, int Wb, int SA, int SH,
                                          int NHP, int MP) {
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
}

template <typename T>
__device__ __forceinline__ void store_band(T* a, T* b, T* a_hs, T* b_hs,
                                           const T* sA, const T* sB,
                                           const T* sAh, const T* sBh,
                                           int c0, int Wb, int SA, int SH,
                                           int NHP, int MP) {
  for (int k = threadIdx.x; k < NHP * Wb; k += blockDim.x) {
    const int n = k / Wb, jj = k - n * Wb;
    const int gi = n * MP + c0 + jj;
    a[gi] = sA[n * SA + jj + HALO_MAIN];
    b[gi] = sB[n * SA + jj + HALO_MAIN];
    a_hs[gi] = sAh[n * SH + jj + HALO_HALF];
    b_hs[gi] = sBh[n * SH + jj + HALO_HALF];
  }
}

// The spill form's body (stepper_stream.cu: spill_chunk): block k of
// gridDim.x bands holds band [c0, c0 + Wk) for the whole chunk, as the
// file's notes say, W resident columns and slab the bands' slabs.  Shared
// memory: a, b with HALO_MAIN columns each side (row stride SA), a_hs, b_hs
// with HALO_HALF (SH), then XS_STAGE + 1 rows of the xs table, then the
// slab's row products, SPILL_SUMS values.  xch holds 2 step parities x
// bands x XCH_LANES x NHP values, part 2 step parities x bands x
// PART_LANES.  The state arrays carry no __restrict__: they are read at the
// start and written at the end.
//
// A step, in order: phase A, the main half-step on the band and its a, b
// halo columns (meanwhile the head warp, block 0's last, adds the previous
// step's partials: finish_step); the row sums; a block barrier; phase B,
// the half-grid half-step on the band, publishing its edge columns of
// a_hs, b_hs to xch[i % 2]; ONE grid barrier; the a_hs, b_hs halo from
// the neighbours (the right one through the slab); a block barrier.  Both
// buffers are double-buffered by step parity: a band writes parity
// (i + 1) % 2 in step i + 1 only after the grid barrier of step i, which
// every reader of that parity's step i - 1 values crossed after reading
// them (the head reads step i - 1's partials before its block reaches the
// grid barrier of step i).  The head warp is the last: its row group has
// as few rows as any, so the adding does not hold up the main half-step.
//
// The tally: the block's first thread reads clock64() at the step loop's
// start and end and on each side of the step's grid barrier.  Its band's
// SPILL_TALLY words of tally hold, after the chunk, the cycles of the whole
// step loop, then the cycles it spent inside grid.sync() (the block's own
// barrier at its entry included), summed over the chunk's steps: the first
// word keeps the loop's start stamp until the loop ends, and each step adds
// to the second by a reduction the thread does not wait for, so that no
// sum stays in a register across the loop (two that did went to local
// memory and cost 0.6-0.7% of a step at N=100 M=20000 on an H100).  The
// stamps read no shared memory and add no barrier.
template <typename T>
__device__ __forceinline__ void spill_band_chunk(
    T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost,
    const T* __restrict__ phi, const T* __restrict__ w_av,
    const T* __restrict__ w_av_phi, const T* __restrict__ xs, T* obs, T* xch,
    T* part, const Params<T>& p, const Geometry& g, int W, int n_steps,
    int parity0, T* slab, long long* tally) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T sums[2][SUM_WARPS][2];
  __shared__ T pend[4];    // the head's pending step (finish_step)
  __shared__ int pflags;
  cg::grid_group grid = cg::this_grid();
  const int NHP = g.NHP, MP = g.MP;
  const int band = blockIdx.x, nb = gridDim.x;
  const int per = MP / nb, rr = MP - per * nb;
  const int c0 = band * per + min(band, rr);
  const int Wb = W;
  const int Sk = per + (band < rr ? 1 : 0) - W;
  const int Smax = per + (rr > 0 ? 1 : 0) - W;
  const int SA = W + 2 * HALO_MAIN, SH = W + 2 * HALO_HALF;
  T* const sA = reinterpret_cast<T*>(smem_raw);
  T* const sB = sA + NHP * SA;
  T* const sAh = sB + NHP * SA;
  T* const sBh = sAh + NHP * SH;
  T* const sX = sBh + NHP * SH;
  const int warp = threadIdx.x >> 5;
  const int cw = W / BAND_ALIGN;
  // the slab: a, b rows of GA values, a_hs, b_hs rows of GH; the products
  // of its rows 0 and 1 (ss)
  const int GA = Smax + 2 * HALO_MAIN, GH = Smax + 2 * HALO_HALF;
  T* const gA = slab + (size_t)band * NHP * (2 * GA + 2 * GH);
  T* const gB = gA + NHP * GA;
  T* const gAh = gB + NHP * GA;
  T* const gBh = gAh + NHP * GH;
  T* const ss = sX + (XS_STAGE + 1) * XS_LANES;

  // the band's last two columns are the slab's
  const Lane<T> L = band_lane<T>(c0, Wb, cw, true, phi, g);
  Lane<T> Ls;   // the thread's slab column
  Ls.RW = blockDim.x / Sk;
  Ls.j = threadIdx.x % Sk;
  Ls.r0 = threadIdx.x / Sk;
  Ls.live = (int)threadIdx.x < Ls.RW * Sk;
  Ls.m = c0 + W + Ls.j;
  Ls.ghost_col = Ls.m == 0 || Ls.m >= g.M + 2;
  Ls.edge_col = Ls.live && Ls.m == g.M + 1;
  Ls.ph = phi[Ls.m];
  Ls.colf_main = (Ls.m >= 1 && Ls.m <= g.M + 1) ? T(1) : T(0);
  Ls.colf_half = (Ls.m >= 1 && Ls.m <= g.M) ? T(1) : T(0);
  Ls.pub = Ls.live && Ls.j >= Sk - 2 ? (2 + Ls.j - (Sk - 2)) * 2 * NHP
                                     : -1;
  const int left = band == 0 ? nb - 1 : band - 1;
  const int right = band + 1 == nb ? 0 : band + 1;
  const size_t slot = (size_t)XCH_LANES * NHP;

  load_band(sA, sB, sAh, sBh, a, b, a_hs, b_hs, c0, Wb, SA, SH, NHP, MP);
  // the slab and its halo columns
  for (int k = threadIdx.x; k < NHP * (Sk + 2 * HALO_MAIN); k += blockDim.x) {
    const int n = k / (Sk + 2 * HALO_MAIN), jj = k - n * (Sk + 2 * HALO_MAIN);
    int col = c0 + W - HALO_MAIN + jj;
    col = col >= MP ? col - MP : col;
    gA[n * GA + jj] = a[n * MP + col];
    gB[n * GA + jj] = b[n * MP + col];
  }
  for (int k = threadIdx.x; k < NHP * (Sk + 2 * HALO_HALF); k += blockDim.x) {
    const int n = k / (Sk + 2 * HALO_HALF), jj = k - n * (Sk + 2 * HALO_HALF);
    int col = c0 + W - HALO_HALF + jj;
    col = col >= MP ? col - MP : col;
    gAh[n * GH + jj] = a_hs[n * MP + col];
    gBh[n * GH + jj] = b_hs[n * MP + col];
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
    spill_products(ss, gA, gB, GA, w_av, w_av_phi, Ls);
    __syncthreads();
    spill_partials(sums, cw, ss, Sk, part + (size_t)(nb + band) * PART_LANES);
    grid.sync();
    if (head) {
      T tot[PART_LANES];
      total_sums(part + (size_t)nb * PART_LANES, nb, tot);
      for (int q = 0; q < PART_LANES; ++q) carry[q] = tot[q];
    }
  }

  // the tally's stamps (the block's first thread)
  const bool stamp = threadIdx.x == 0;
  long long* const mine = tally + SPILL_TALLY * band;
  if (stamp) {
    mine[1] = 0;
    mine[0] = clock64();
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
    // the slab's side of the two half-steps
    const SlabPart<T> slab_a = {
        gA, gB, gAh, gBh, GA, GH, nullptr,
        (p.E_dc + p.E_omega * row[0] + p.B * Ls.ph) * p.dt / T(2),
        (p.E_dc + p.E_omega * row[1] + p.B * Ls.ph) * p.dt / T(2),
        Ls.colf_main, &Ls};
    const SlabPart<T> slab_b = {
        gAh, gBh, gA, gB, GH, GA,
        Ls.pub < 0 ? nullptr : xch + (par * nb + band) * slot + Ls.pub,
        (p.E_dc + p.E_omega * row[2] + p.B * Ls.ph) * p.dt / T(2),
        (p.E_dc + p.E_omega * row[3] + p.B * Ls.ph) * p.dt / T(2),
        Ls.colf_half, &Ls};
    halo_cells<T, true>(gA, gB, gAh, gBh, GA, GH, c0 + W, Sk, a0, a0_ghost,
                        phi, row[0], row[1], gf, p, g);
    halo_cells(sA, sB, sAh, sBh, SA, SH, c0, Wb, a0, a0_ghost, phi, row[0],
               row[1], gf, p, g);
    band_half_step<T, true, true>(
        sA, sB, sAh, sBh, SA, HALO_MAIN, SH, HALO_HALF, a0, a0_ghost,
        nullptr, nullptr, nullptr,
        (p.E_dc + p.E_omega * row[0] + p.B * L.ph) * p.dt / T(2),
        (p.E_dc + p.E_omega * row[1] + p.B * L.ph) * p.dt / T(2),
        L.colf_main, gf, p, g, L, &slab_a);
    if (need) {
      row_sums(sums, sA, sB, SA, w_av, w_av_phi, L);
      spill_products(ss, gA, gB, GA, w_av, w_av_phi, Ls);
    }
    __syncthreads();
    if (need)
      spill_partials(sums, cw, ss, Sk, part + (par * nb + band) * PART_LANES);

    // phase B: the half grid against the new a, b; its edge columns out
    band_half_step<T, false, true>(
        sAh, sBh, sA, sB, SH, HALO_HALF, SA, HALO_MAIN, a0, a0_ghost, edge_a,
        edge_b, L.pub < 0 ? nullptr : xch + (par * nb + band) * slot + L.pub,
        (p.E_dc + p.E_omega * row[2] + p.B * L.ph) * p.dt / T(2),
        (p.E_dc + p.E_omega * row[3] + p.B * L.ph) * p.dt / T(2),
        L.colf_half, T(0), p, g, L, &slab_b);
    long long sync0 = 0;
    if (stamp) sync0 = clock64();
    grid.sync();
    if (stamp)   // a reduction: the thread does not wait for it
      atomicAdd(reinterpret_cast<unsigned long long*>(mine + 1),
                (unsigned long long)(clock64() - sync0));
    fill_halo<T, true>(sAh, sBh, xch + par * nb * slot, left, right, NHP, SH,
                       Wb, gAh, gBh, GH, Sk);
    __syncthreads();
  }
  if (stamp) mine[0] = clock64() - mine[0];
  if (head)   // the last step's av and record
    finish_step(r, carry, part + (size_t)((n_steps - 1) & 1) * nb * PART_LANES,
                nb, pend, pflags, p.dt, obs);

  store_band(a, b, a_hs, b_hs, sA, sB, sAh, sBh, c0, Wb, SA, SH, NHP, MP);
  for (int k = threadIdx.x; k < NHP * Sk; k += blockDim.x) {
    const int n = k / Sk, jj = k - n * Sk;
    const int gi = n * MP + c0 + W + jj;
    a[gi] = gA[n * GA + jj + HALO_MAIN];
    b[gi] = gB[n * GA + jj + HALO_MAIN];
    a_hs[gi] = gAh[n * GH + jj + HALO_HALF];
    b_hs[gi] = gBh[n * GH + jj + HALO_HALF];
  }
  if (head0)
    for (int q = 0; q < 8; ++q) av[q] = r[q];
}

// ---- B1's resident form: the split-phase step --------------------------

// The resident form's grid barrier, split in two on one counter in device
// memory.  grid_arrive: one thread adds 1, a release at the card's scope
// (after a block barrier, so that every store its block made before it is
// seen by whoever sees the count).  grid_poll: one thread reads the
// counter (an acquire) until every band's g-th arrival is in (target =
// bands · g; compared by difference, so the count may wrap), and returns
// whether the first read found the barrier open; the block barrier that
// follows hands the ordering on to its block.
__device__ __forceinline__ void grid_arrive(unsigned* ctr) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(ctr), "r"(1u) : "memory");
}

// whether this thread is B1's resident form's head (block 0's next-to-last
// warp: resident_band_chunk), from %tid.x and %ctaid.x read anew, so that
// no predicate for it stays live across the step loop
__device__ __forceinline__ bool head_now() {
  unsigned t, b;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b == 0 && (t >> 5) == (blockDim.x >> 5) - 2;
}

// adds v to a tally word by a reduction the thread does not wait for
__device__ __forceinline__ void tally_add(long long* word, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(word),
            static_cast<unsigned long long>(v));
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ bool grid_poll(const unsigned* ctr,
                                          unsigned target) {
  unsigned v = load_acquire(ctr);
  const bool open = (int)(v - target) >= 0;
  while ((int)(v - target) < 0) v = load_acquire(ctr);
  return open;
}

// One half-step on a band's edge cells, one a thread from the block's last
// thread down (the row groups with the fewest rows): MAIN the main grid on
// the a, b halo columns -1 and Wb, else the half grid on the band's outer
// columns 0, 1, Wb - 2 and Wb - 1 (the ones that read what the halo
// produced), published to pub (the band's exchange slot: edge q at offset
// q · 2 · NHP, a_hs then b_hs, as fill_halo reads them).  Cell k: edge
// k / NHP, row k % NHP, by the general cell with its column's terms
// computed as band_lane and own_cell compute them (halo_cells' for the
// halo columns): the same bits.  As own_cell's B1: the loads the cell
// ends with are issued before it.
template <typename T, bool MAIN>
__device__ __forceinline__ void edge_cells(
    T* dA, T* dB, const T* nA, const T* nB, int Sd, int hd, int Sn, int hn,
    int c0, int Wb, const T* __restrict__ a0, const T* __restrict__ a0_ghost,
    const T* __restrict__ phi, T* __restrict__ edge_a,
    T* __restrict__ edge_b, T* __restrict__ pub, T cos_t, T cos_t_dt, T gf,
    const Params<T>& p, const Geometry& g) {
  const int NHP = g.NHP, MP = g.MP;
  constexpr int EDGES = MAIN ? 2 : 4;
  for (int k = blockDim.x - 1 - threadIdx.x; k < EDGES * NHP;
       k += blockDim.x) {
    const int q = k / NHP, n = k - q * NHP;
    const int c = MAIN ? (q ? Wb : -1) : (q < 2 ? q : Wb - 4 + q);
    int col = c0 + c;
    col = col < 0 ? col + MP : (col >= MP ? col - MP : col);
    const int gi = n * MP + col;
    const bool ghost = MAIN && (col == 0 || col >= g.M + 2 || n >= g.N);
    const bool edge = !MAIN && col == g.M + 1;
    const T gv = ghost ? __ldg(a0_ghost + gi) : T(0);
    const T ea = edge ? edge_a[n] : T(0), eb = edge ? edge_b[n] : T(0);
    const T ph = __ldg(phi + col);
    const int od = n * Sd + c + hd;
    T a_src, b_src, a_new, b_new;
    band_cell<T, false>(
        dA, dB, nA, nB, od, n * Sn + c + hn, Sn, n, NHP, g.N, T(0),
        (p.E_dc + p.E_omega * cos_t + p.B * ph) * p.dt / T(2),
        (p.E_dc + p.E_omega * cos_t_dt + p.B * ph) * p.dt / T(2),
        (col >= 1 && col <= (MAIN ? g.M + 1 : g.M)) ? T(1) : T(0),
        __ldg(a0 + gi), p, a_src, b_src, a_new, b_new);
    if (MAIN) {
      a_new = a_new + gf * (ghost ? gv : T(0));
    } else if (edge) {
      a_new = ea;
      b_new = eb;
      edge_a[n] = a_src;
      edge_b[n] = b_src;
    }
    dA[od] = a_new;
    dB[od] = b_new;
    if (!MAIN) {
      __stcg(pub + q * 2 * NHP + n, a_new);
      __stcg(pub + q * 2 * NHP + NHP + n, b_new);
    }
  }
}

// B1's resident form's body (stepper.cu: resident_chunk): block k of
// gridDim.x bands holds band k, [k·W, min((k+1)·W, MP)), for the whole
// chunk.  Shared memory: a, b with HALO_MAIN columns each side (row stride
// SA), a_hs, b_hs with HALO_HALF (SH), then XS_STAGE + 1 rows of the xs
// table.  xch holds 2 step parities x bands x XCH_LANES x NHP values, part
// PART_SLOTS steps x bands x PART_LANES; sync is the barrier's counter,
// the count of blocks that have left, and each band's tally (its waits,
// and those its first read found open) of the chunk; tally holds each
// band's B1_TALLY int64 words of cycles (below).  The state arrays carry no
// __restrict__: they are read at the start and written at the end.
//
// Of the half-grid half-step's cells only the band's four outer columns
// feed the neighbours; the rest, ~90% of them at W = 32, run while those
// edges travel.  Step i:
//   1. phase A: the main half-step on the band (its halo columns by the
//      block's last threads), from the halo read at the end of step i - 1;
//      the row sums of the new a, b; a block barrier;
//   2. phase B's edges (edge_cells), published to xch[i % 2], and the
//      band's partials to part[i % PART_SLOTS]; a block barrier;
//   3. the last warp's first lane (the syncer; its row group has as few
//      rows as any) arrives; the head warp (block 0's next-to-last) adds
//      step i - 1's partials (finish_step: av and the display-77 record);
//      every warp runs phase B's interior, columns 2 .. Wb - 3; then the
//      syncer waits for every band's arrival of step i; a block barrier;
//   4. the a_hs, b_hs halo from the neighbours' edges in xch[i % 2]; a
//      block barrier (not after the last step, whose halo no one reads).
// The wait at the end of a step's interior usually finds the barrier
// open: the neighbours arrived an interior earlier.  After the last step
// the head finishes it and the band writes its part of the state back,
// every band having arrived (a neighbour's halo read it at the chunk's
// start); the last block out sets the counter back to 0 for the next
// chunk.  The cells are own_cell's B1 (the ghost values and the carried
// edge loaded before the arithmetic), so that a band with ghost columns or
// column M+1 is not the one every other band waits for.
//
// Why the buffers hold: a band writes xch[i % 2] in step i after the wait
// for step i - 1, which every band passed only after it had read the
// values of step i - 2 in that slot (at the end of step i - 2, before its
// arrival of step i - 1).  The head reads step i - 1's partials after the
// wait for step i - 1 and after band 0's arrival of step i; that slot,
// (i - 1) % 3, is written again in step i + 2, after the wait for step
// i + 1, which band 0's arrival of step i + 1, after the head's read,
// opens: hence three slots.  Every cell by band_cell's arithmetic in
// half_step_cell's operand order: the state and edges bit for bit with
// the plain version; the sums in band order, as the spill form's.
//
// The cycle tally: the syncer reads clock64() at the step loop's start and
// end and, each step, where phase B's edges begin (after phase A's block
// barrier), just after its arrival, just before its wait (its interior
// rows done) and after the halo read's block barrier (the wait's, after
// the last step).  Its band's B1_TALLY words hold, after the chunk, the
// cycles of the whole step loop, then the exposed cycles summed over the
// chunk's steps: (arrival - edges' start) + (halo's end - wait's start),
// the part of a step in which the band computes no interior cell.  As in
// spill_band_chunk, the first word keeps the loop's start stamp until the
// loop ends, and no sum stays in a register across the loop; nor does a
// stamp across a phase: each stamp goes to the second word at once, the
// earlier of a pair negated, by a reduction the thread does not wait for.
// The stamps read no shared memory and add no barrier.  The kernel runs at
// its 64 registers, and the stamps' addresses and tests pushed a value
// held across the loop into local memory (the head's test, then a loop
// bound: 8 bytes a thread), so the loop holds two values fewer than it
// did: the head's test is read anew where it is used (head_now), and the
// syncer's waits, one a step, are n_steps.
template <typename T>
__device__ __forceinline__ void resident_band_chunk(
    T* a, T* b, T* a_hs, T* b_hs, T* edge_a, T* edge_b, T* av,
    const T* __restrict__ a0, const T* __restrict__ a0_ghost,
    const T* __restrict__ phi, const T* __restrict__ w_av,
    const T* __restrict__ w_av_phi, const T* __restrict__ xs, T* obs, T* xch,
    T* part, unsigned* sync, long long* tally, const Params<T>& p,
    const Geometry& g, int W, int n_steps, int parity0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T sums[2][SUM_WARPS][2];
  __shared__ T pend[4];    // the head's pending step (finish_step)
  __shared__ int pflags;
  const int NHP = g.NHP, MP = g.MP;
  const int band = blockIdx.x, nb = gridDim.x;
  const int c0 = band * W, Wb = min(W, MP - c0);
  const int SA = W + 2 * HALO_MAIN, SH = W + 2 * HALO_HALF;
  T* const sA = reinterpret_cast<T*>(smem_raw);
  T* const sB = sA + NHP * SA;
  T* const sAh = sB + NHP * SA;
  T* const sBh = sAh + NHP * SH;
  T* const sX = sBh + NHP * SH;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int cw = W / BAND_ALIGN;
  const Lane<T> L = band_lane<T>(c0, Wb, cw, false, phi, g);
  Lane<T> LB = L;   // phase B's interior
  LB.live = L.live && L.j >= 2 && L.j < Wb - 2;
  const int left = band == 0 ? nb - 1 : band - 1;
  const int right = band + 1 == nb ? 0 : band + 1;
  const size_t slot = (size_t)XCH_LANES * NHP;

  load_band(sA, sB, sAh, sBh, a, b, a_hs, b_hs, c0, Wb, SA, SH, NHP, MP);
  // adds the partials: block 0's next-to-last warp; av in its lane 0 (from
  // the step loop on, head_now())
  const bool head = band == 0 && warp == nw - 2;
  const bool head0 = head && (threadIdx.x & 31) == 0;
  // arrives and waits: the last warp's first lane
  const bool syncer = threadIdx.x == blockDim.x - 32;
  T r[8] = {};
  T carry[PART_LANES] = {T(0), T(0), T(0), T(0)};   // pre-step sums
  if (head0)
    for (int q = 0; q < 8; ++q) r[q] = av[q];
  // every band's arrivals so far; the syncer's open waits (it waits once a
  // step)
  unsigned gen = 0;
  int open = 0;
  __syncthreads();

  if (xs[8] > T(0)) {   // the first step's record needs its pre-step sums
    // (step -1's: slot PART_SLOTS - 1)
    row_sums(sums, sA, sB, SA, w_av, w_av_phi, L);
    __syncthreads();
    ++gen;
    if (warp == 0) {
      if (threadIdx.x == 0) {
        band_partials(sums, cw,
                      part + (size_t)((PART_SLOTS - 1) * nb + band) *
                                 PART_LANES);
        grid_arrive(sync);
        grid_poll(sync, nb * gen);
      }
      __syncwarp();
    }
    __syncthreads();
    if (head) {
      T tot[PART_LANES];
      total_sums(part + (size_t)(PART_SLOTS - 1) * nb * PART_LANES, nb, tot);
      for (int q = 0; q < PART_LANES; ++q) carry[q] = tot[q];
    }
  }

  // the tally's stamps (the syncer)
  long long* const mine = tally + B1_TALLY * band;
  if (syncer) {
    mine[1] = 0;
    mine[0] = clock64();
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

    // 1. phase A, the row sums
    edge_cells<T, true>(sA, sB, sAh, sBh, SA, HALO_MAIN, SH, HALO_HALF, c0,
                        Wb, a0, a0_ghost, phi, nullptr, nullptr, nullptr,
                        row[0], row[1], gf, p, g);
    band_half_step<T, true, false, true>(
        sA, sB, sAh, sBh, SA, HALO_MAIN, SH, HALO_HALF, a0, a0_ghost,
        nullptr, nullptr, nullptr,
        (p.E_dc + p.E_omega * row[0] + p.B * L.ph) * p.dt / T(2),
        (p.E_dc + p.E_omega * row[1] + p.B * L.ph) * p.dt / T(2),
        L.colf_main, gf, p, g, L);
    if (need) row_sums(sums, sA, sB, SA, w_av, w_av_phi, L);
    __syncthreads();
    if (syncer) tally_add(mine + 1, -clock64());
    // 2. phase B's edges out, the partials
    edge_cells<T, false>(sAh, sBh, sA, sB, SH, HALO_HALF, SA, HALO_MAIN, c0,
                         Wb, a0, a0_ghost, phi, edge_a, edge_b,
                         xch + ((size_t)(i & 1) * nb + band) * slot, row[2],
                         row[3], T(0), p, g);
    if (need && threadIdx.x == 0)
      band_partials(sums, cw, part + ((size_t)(i % PART_SLOTS) * nb + band) *
                                         PART_LANES);
    __syncthreads();
    // 3. the arrival; the head finishes step i - 1; phase B's interior;
    // the wait
    ++gen;
    if (syncer) {
      grid_arrive(sync);
      tally_add(mine + 1, clock64());
    }
    if (head_now()) {
      if (i > 0)
        finish_step(r, carry,
                    part + (size_t)((i - 1) % PART_SLOTS) * nb * PART_LANES,
                    nb, pend, pflags, p.dt, obs);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
        pend[0] = row[4];
        pend[1] = row[5];
        pend[2] = row[7];
        pend[3] = row[9];
        pflags = (need ? 1 : 0) | (do_av ? 2 : 0) | (emit ? 4 : 0);
      }
      __syncwarp();
    }
    band_half_step<T, false, false, true>(
        sAh, sBh, sA, sB, SH, HALO_HALF, SA, HALO_MAIN, a0, a0_ghost, edge_a,
        edge_b, nullptr,
        (p.E_dc + p.E_omega * row[2] + p.B * L.ph) * p.dt / T(2),
        (p.E_dc + p.E_omega * row[3] + p.B * L.ph) * p.dt / T(2),
        L.colf_half, T(0), p, g, LB);
    if (warp == nw - 1) {   // the syncer's warp leaves together
      if (syncer) {
        tally_add(mine + 1, -clock64());
        open += grid_poll(sync, nb * gen);
      }
      __syncwarp();
    }
    __syncthreads();
    // 4. the halo
    if (i + 1 < n_steps) {
      fill_halo(sAh, sBh, xch + (size_t)(i & 1) * nb * slot, left, right,
                NHP, SH, Wb);
      __syncthreads();
    }
    if (syncer) tally_add(mine + 1, clock64());
  }
  if (syncer) mine[0] = clock64() - mine[0];
  if (head_now())   // the last step's av and record
    finish_step(r, carry,
                part + (size_t)((n_steps - 1) % PART_SLOTS) * nb * PART_LANES,
                nb, pend, pflags, p.dt, obs);

  store_band(a, b, a_hs, b_hs, sA, sB, sAh, sBh, c0, Wb, SA, SH, NHP, MP);
  if (head_now() && (threadIdx.x & 31) == 0)
    for (int q = 0; q < 8; ++q) av[q] = r[q];
  if (syncer) {
    sync[SYNC_WORDS + 2 * band] = n_steps;
    sync[SYNC_WORDS + 2 * band + 1] = open;
    if (atomicAdd(sync + 1, 1u) == (unsigned)nb - 1) {   // the last out
      atomicExch(sync, 0u);
      atomicExch(sync + 1, 0u);
    }
  }
}

}  // namespace slb
