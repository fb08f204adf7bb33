// What a neighbour read costs on an NVIDIA Hopper card (sm_90a): K passes
// of x = x + roll(x, 1, axis) over float32 arrays.
//
// Replaces the Pallas TPU probes tests/perf/roll_cost_experiment.py
// `_kernel_two` (two (R, C) arrays, two rolls per pass) and `_kernel_one`
// (one stacked (2R, C) array, one roll per pass) (probe P2).  roll(x, 1,
// axis) is numpy's: element i of the rolled axis reads element i - 1, and
// element 0 reads the last.  axis 1 is the contiguous one (m in the step
// kernels), axis 0 is strided by C (n).  A line is one row (axis 1) or
// one column (axis 0) of one array.
//
// Two kernels, and with them the three ways a resident step can reach its
// neighbour (a shuffle, shared memory behind a block barrier, a launch):
//   registers (roll_reg_warp, roll_reg_halo): every line in registers, V
//     consecutive elements a thread, updated from the high end down
//     (x[j] += x[j-1] reads the old x[j-1]); element 0 of a thread takes
//     the old last element of the thread to its left by a shuffle.
//     roll_reg_warp: a line of P·V elements in P lanes (P a power of two
//     up to 32; the line wraps in the shuffle), no barrier at all; axis 0
//     (lines of 104 and 208: P = 8, 16, V = 13).  roll_reg_halo: a line of
//     L = warps · S elements, one block a line, each warp a window of 32·V
//     elements: T of halo (copies of the previous warp's last T, the line
//     wrapping) and S = 32·V - T of its own.  A pass spoils one more halo
//     element from the left (lane 0's shuffle brings nothing), so after at
//     most T passes the warps exchange their last T elements through shared
//     memory behind one block barrier (`every` passes apart, 1 <= every <=
//     T; the exchange buffer double-buffered by refresh); axis 1 (lines of
//     4096: 208 blocks over the 132 SMs).  One instance, V = 17, T = 32
//     (8 warps a line of 4096): the fastest of four timed (PERF.md §6).  Every value is one add of the
//     same two operands as the plain version's, so the result is bit for
//     bit; the T halo elements are the redundant work.  Both stage their
//     lines through shared memory once, so the loads and stores coalesce.
//     They replace the TPU design's counterpart, one block holding whole
//     lines in shared memory with a block barrier every pass, which was
//     about 15x slower at the probe's shape on an H100 (PERF.md §6).
//   per pass (roll_pass): B1's pattern, a kernel boundary as the barrier.
//     One launch per pass and array (form "two": two launches per pass)
//     reads the previous pass's array through L2 and writes the next one;
//     buffers ping-pong.  Bound by the launch rate: a pass moves ~3.4 MB
//     through L2, well under a microsecond of its bandwidth.
//
// What bounds the function: one add per element and pass, 852k a pass at
// the probe's shape (0.0254 us at 3.35e13 op/s).

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

// one pass over one (rows, cols) array: out = in + roll(in, 1, axis)
__global__ void roll_pass(const float* __restrict__ in,
                          float* __restrict__ out, int rows, int cols,
                          int axis) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  const int r = i / cols, c = i - r * cols;
  const int nb = axis == 1 ? r * cols + (c == 0 ? cols - 1 : c - 1)
                           : (r == 0 ? rows - 1 : r - 1) * cols + c;
  out[i] = in[i] + in[nb];
}

// ---- registers ---------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_BLOCK = 256;   // threads of a roll_reg_warp block

// element e of line `line` of a (rows, cols) array along axis
__device__ __forceinline__ size_t line_elem(int axis, int cols, int line,
                                            int e) {
  return axis ? (size_t)line * cols + e : (size_t)e * cols + line;
}

// Lines of L = P·V elements, P lanes a line, WARP_BLOCK / P lines a block
// (grid.y: the array).  Shared memory: the block's lines, line l element e
// at l·ls + e·es (axis 1: ls = L + 1, es = 1; axis 0: ls = 1, es = lines
// + 1), so the staging walks the contiguous axis.
template <int V>
__global__ void __launch_bounds__(WARP_BLOCK)
    roll_reg_warp(float* __restrict__ x, float* __restrict__ y, int rows,
                  int cols, int axis, int P, int K) {
  extern __shared__ float tile[];
  float* const arr = blockIdx.y ? y : x;
  const int L = axis ? cols : rows, nl = axis ? rows : cols;
  const int LPB = blockDim.x / P;
  const int line0 = blockIdx.x * LPB, nb = min(LPB, nl - line0);
  const int ls = axis ? L + 1 : 1, es = axis ? 1 : LPB + 1;
  for (int k = threadIdx.x; k < nb * L; k += blockDim.x) {
    int l, e;
    if (axis) {
      l = k / L;
      e = k - l * L;
    } else {
      e = k / nb;
      l = k - e * nb;
    }
    tile[l * ls + e * es] = arr[line_elem(axis, cols, line0 + l, e)];
  }
  __syncthreads();
  const int l = threadIdx.x / P, li = threadIdx.x % P;
  const bool live = l < nb;
  const int o = l * ls + li * V * es;
  float v[V];
#pragma unroll
  for (int q = 0; q < V; ++q) v[q] = live ? tile[o + q * es] : 0.0f;
  const int src = (li + P - 1) % P;   // the lane to the left, wrapping
  for (int k = 0; k < K; ++k) {
    const float left = __shfl_sync(FULL, v[V - 1], src, P);
#pragma unroll
    for (int q = V - 1; q > 0; --q) v[q] = v[q] + v[q - 1];
    v[0] = v[0] + left;
  }
  if (live)
#pragma unroll
    for (int q = 0; q < V; ++q) tile[o + q * es] = v[q];
  __syncthreads();
  for (int k = threadIdx.x; k < nb * L; k += blockDim.x) {
    int l2, e;
    if (axis) {
      l2 = k / L;
      e = k - l2 * L;
    } else {
      e = k / nb;
      l2 = k - e * nb;
    }
    arr[line_elem(axis, cols, line0 + l2, e)] = tile[l2 * ls + e * es];
  }
}

// One line a block (grid.x the line, grid.y the array), L / S warps.
// Shared memory: the line (L floats), then the exchange buffer, 2 refresh
// parities x warps x T.  Warp w's window starts at line element w·S - T
// (the line wrapping); window element i = lane·V + q: i < T its halo,
// i >= S its last T, which the next warp's halo copies.
template <int V, int T>
__global__ void __launch_bounds__(1024)
    roll_reg_halo(float* __restrict__ x, float* __restrict__ y, int rows,
                  int cols, int axis, int K, int every) {
  constexpr int S = 32 * V - T;
  extern __shared__ float sh[];
  float* const arr = blockIdx.y ? y : x;
  const int L = axis ? cols : rows, line = blockIdx.x;
  const int wpl = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* const xb = sh + L;
  for (int e = threadIdx.x; e < L; e += blockDim.x)
    sh[e] = arr[line_elem(axis, cols, line, e)];
  __syncthreads();
  const int base = w * S - T + lane * V;
  float v[V];
#pragma unroll
  for (int q = 0; q < V; ++q) v[q] = sh[base + q < 0 ? base + q + L : base + q];
  const int pw = w == 0 ? wpl - 1 : w - 1;
  for (int k0 = 0, r = 0; k0 < K; k0 += every, ++r) {
    if (k0 > 0) {   // the halo from the previous warp's last T
      float* const buf = xb + (r & 1) * wpl * T;
#pragma unroll
      for (int q = 0; q < V; ++q)
        if (lane * V + q >= S) buf[w * T + lane * V + q - S] = v[q];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < V; ++q)
        if (lane * V + q < T) v[q] = buf[pw * T + lane * V + q];
    }
    const int n = min(every, K - k0);
    for (int k = 0; k < n; ++k) {
      const float left = __shfl_up_sync(FULL, v[V - 1], 1);
#pragma unroll
      for (int q = V - 1; q > 0; --q) v[q] = v[q] + v[q - 1];
      v[0] = v[0] + left;
    }
  }
  __syncthreads();   // every warp has read its window from sh
#pragma unroll
  for (int q = 0; q < V; ++q)
    if (lane * V + q >= T) sh[base + q] = v[q];
  __syncthreads();
  for (int e = threadIdx.x; e < L; e += blockDim.x)
    arr[line_elem(axis, cols, line, e)] = sh[e];
}

template <typename Kernel>
int launch_smem(Kernel kernel, dim3 grid, int block, size_t bytes,
                cudaStream_t s, float* x, float* y, int rows, int cols,
                int axis, int a, int b) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, block, bytes, s>>>(x, y, rows, cols, axis, a, b);
  return (int)cudaGetLastError();
}

template <int V>
int reg_warp(float* x, float* y, int narr, int rows, int cols, int axis,
             int K, cudaStream_t s) {
  const int L = axis ? cols : rows, nl = axis ? rows : cols;
  if (L % V) return (int)cudaErrorInvalidValue;
  const int P = L / V;
  if (P > 32 || (P & (P - 1))) return (int)cudaErrorInvalidValue;
  const int LPB = WARP_BLOCK / P;
  const size_t bytes = sizeof(float) * (axis ? (size_t)LPB * (L + 1)
                                             : (size_t)L * (LPB + 1));
  return launch_smem(roll_reg_warp<V>, dim3((nl + LPB - 1) / LPB, narr),
                     WARP_BLOCK, bytes, s, x, y, rows, cols, axis, P, K);
}

template <int V, int T>
int reg_halo(float* x, float* y, int narr, int rows, int cols, int axis,
             int K, int every, cudaStream_t s) {
  constexpr int S = 32 * V - T;
  const int L = axis ? cols : rows, nl = axis ? rows : cols;
  if (L % S || L / S > 32 || T > S || every < 1 || every > T)
    return (int)cudaErrorInvalidValue;
  const int wpl = L / S;
  const size_t bytes = sizeof(float) * ((size_t)L + 2 * wpl * T);
  return launch_smem(roll_reg_halo<V, T>, dim3(nl, narr), 32 * wpl, bytes,
                     s, x, y, rows, cols, axis, K, every);
}

}  // namespace

// C entry points (bound with ctypes in perf/roll_cost_experiment.py).  All
// arrays are contiguous (rows, cols) float32 on the device; y == nullptr
// selects form "one" (x is the one array), else form "two" (x and y, each
// rows x cols).  Both enqueue on `stream`, do not synchronise, and return 0
// or the first cudaError_t.
//
// slb_roll_passes_f32: K passes, one launch per pass and array; pass k
// reads x[k % 2] (and y[k % 2]) and writes x[(k + 1) % 2], so the result
// ends in x[K % 2].
extern "C" int slb_roll_passes_f32(void* x0, void* x1, void* y0, void* y1,
                                   int rows, int cols, int axis, int K,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (rows * cols + BLOCK - 1) / BLOCK;
  float* xs[2] = {(float*)x0, (float*)x1};
  float* ys[2] = {(float*)y0, (float*)y1};
  for (int k = 0; k < K; ++k) {
    const int src = k & 1, dst = src ^ 1;
    roll_pass<<<grid, BLOCK, 0, s>>>(xs[src], xs[dst], rows, cols, axis);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (ys[0] != nullptr) {
      roll_pass<<<grid, BLOCK, 0, s>>>(ys[src], ys[dst], rows, cols, axis);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

// slb_roll_registers_f32: K passes in place, one launch, on the register
// kernels: kind 0 roll_reg_warp with V elements a lane (V in 1, 4, 13:
// lines of up to 32, of 128, of 104 and 208; the line's length / V lanes
// a line, a power of two up to 32), kind 1 roll_reg_halo with V = 17,
// T = 32 and the halo refreshed every `every` passes (1 <= every <= T;
// the line's length a multiple of 512, at most 32 warps).  Any other shape
// returns cudaErrorInvalidValue before launching.
extern "C" int slb_roll_registers_f32(void* x, void* y, int rows, int cols,
                                      int axis, int K, int kind, int V,
                                      int T, int every, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *X = (float*)x, *Y = (float*)y;
  const int narr = y == nullptr ? 1 : 2;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  if (kind == 0 && T == 0) {
    switch (V) {
      case 1: return reg_warp<1>(X, Y, narr, rows, cols, axis, K, s);
      case 4: return reg_warp<4>(X, Y, narr, rows, cols, axis, K, s);
      case 13: return reg_warp<13>(X, Y, narr, rows, cols, axis, K, s);
    }
  } else if (kind == 1) {
    if (V == 17 && T == 32)
      return reg_halo<17, 32>(X, Y, narr, rows, cols, axis, K, every, s);
  }
  return (int)cudaErrorInvalidValue;
}
