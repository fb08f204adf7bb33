// What a neighbour read costs on an NVIDIA Hopper card (sm_90a): K passes
// of x = x + roll(x, 1, axis) over float32 arrays.
//
// Replaces the Pallas TPU probes tests/perf/roll_cost_experiment.py
// `_kernel_two` (two (R, C) arrays, two rolls per pass) and `_kernel_one`
// (one stacked (2R, C) array, one roll per pass) (probe P2).  roll(x, 1,
// axis) is numpy's: element i of the rolled axis reads element i - 1, and
// element 0 reads the last.  axis 1 is the contiguous one (m in the step
// kernels), axis 0 is strided by C (n).
//
// Two kernels, two answers:
//   resident (roll_resident_rows, roll_resident_cols): the TPU design's
//     counterpart.  One block holds whole lines along the rolled axis in
//     shared memory -- one row per array for axis 1 (C floats each), a
//     strip of STRIP columns of every row for axis 0 -- runs all K passes
//     with one block barrier per pass (ping-pong buffers: a pass reads one
//     and writes the other, so the neighbour read never races the write),
//     and writes the result back once.  Form "two" gives a block the same
//     lines of both arrays (two rolls per pass), form "one" its lines of the
//     stacked array.  Bound by the barrier and shared-memory latency per
//     pass; axis 1 at R=104 rows runs 104 blocks, fewer than the 132 SMs.
//   per pass (roll_pass): B1's pattern, a kernel boundary as the barrier.
//     One launch per pass and array (form "two": two launches per pass)
//     reads the previous pass's array through L2 and writes the next one;
//     buffers ping-pong.  Bound by the launch rate: a pass moves ~3.4 MB
//     through L2, well under a microsecond of its bandwidth.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int STRIP = 16;   // columns per block for axis 0

// axis 1: block b holds row b of x (and of y in form "two")
template <int NARR>
__global__ void roll_resident_rows(float* __restrict__ x,
                                   float* __restrict__ y, int cols, int K) {
  extern __shared__ float sh[];          // [NARR][2][cols]
  float* rows[2] = {x + (size_t)blockIdx.x * cols,
                    NARR == 2 ? y + (size_t)blockIdx.x * cols : nullptr};
  for (int a = 0; a < NARR; ++a)
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      sh[(a * 2) * cols + c] = rows[a][c];
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const int src = k & 1, dst = src ^ 1;
    for (int a = 0; a < NARR; ++a) {
      const float* s = sh + (a * 2 + src) * cols;
      float* d = sh + (a * 2 + dst) * cols;
      for (int c = threadIdx.x; c < cols; c += blockDim.x)
        d[c] = s[c] + s[c == 0 ? cols - 1 : c - 1];
    }
    __syncthreads();
  }
  for (int a = 0; a < NARR; ++a)
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      rows[a][c] = sh[(a * 2 + (K & 1)) * cols + c];
}

// axis 0: block b holds columns [b*STRIP, (b+1)*STRIP) of every row of x
// (and of y in form "two"); thread (tx, ty) walks rows ty, ty + 16, ...
template <int NARR>
__global__ void roll_resident_cols(float* __restrict__ x,
                                   float* __restrict__ y, int rows, int cols,
                                   int K) {
  extern __shared__ float sh[];          // [NARR][2][rows][STRIP]
  const int tx = threadIdx.x % STRIP, ty = threadIdx.x / STRIP;
  const int ny = blockDim.x / STRIP;
  const int c = blockIdx.x * STRIP + tx;
  const int plane = rows * STRIP;
  float* arr[2] = {x, NARR == 2 ? y : nullptr};
  for (int a = 0; a < NARR; ++a)
    for (int r = ty; r < rows; r += ny)
      sh[(a * 2) * plane + r * STRIP + tx] = arr[a][(size_t)r * cols + c];
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const int src = k & 1, dst = src ^ 1;
    for (int a = 0; a < NARR; ++a) {
      const float* s = sh + (a * 2 + src) * plane;
      float* d = sh + (a * 2 + dst) * plane;
      for (int r = ty; r < rows; r += ny)
        d[r * STRIP + tx] =
            s[r * STRIP + tx] + s[(r == 0 ? rows - 1 : r - 1) * STRIP + tx];
    }
    __syncthreads();
  }
  for (int a = 0; a < NARR; ++a)
    for (int r = ty; r < rows; r += ny)
      arr[a][(size_t)r * cols + c] =
          sh[(a * 2 + (K & 1)) * plane + r * STRIP + tx];
}

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

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NARR>
int resident(float* x, float* y, int rows, int cols, int axis, int K,
             cudaStream_t s) {
  int err;
  if (axis == 1) {
    const size_t bytes = sizeof(float) * NARR * 2 * cols;
    if ((err = set_smem(roll_resident_rows<NARR>, bytes))) return err;
    roll_resident_rows<NARR><<<rows, BLOCK, bytes, s>>>(x, y, cols, K);
  } else {
    if (cols % STRIP) return (int)cudaErrorInvalidValue;
    const size_t bytes = sizeof(float) * NARR * 2 * rows * STRIP;
    if ((err = set_smem(roll_resident_cols<NARR>, bytes))) return err;
    roll_resident_cols<NARR><<<cols / STRIP, BLOCK, bytes, s>>>(x, y, rows,
                                                               cols, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes in perf/roll_cost_experiment.py).  All
// arrays are contiguous (rows, cols) float32 on the device; y == nullptr
// selects form "one" (x is the one array), else form "two" (x and y, each
// rows x cols).  Both enqueue on `stream`, do not synchronise, and return 0
// or the first cudaError_t.
//
// slb_roll_resident_f32: K passes in place, one launch.
extern "C" int slb_roll_resident_f32(void* x, void* y, int rows, int cols,
                                     int axis, int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return y == nullptr
             ? resident<1>((float*)x, nullptr, rows, cols, axis, K, s)
             : resident<2>((float*)x, (float*)y, rows, cols, axis, K, s);
}

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
