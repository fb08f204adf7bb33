// The card's float32 elementwise rate on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU probe tests/perf/vpu_roofline.py:bench_pallas
// `kernel` (probe P1): every element of a (NHP, MP) float32 array runs
// `reps` turns of the 64-step chain y = y * coef[i] + bias[i], with the
// array resident (VMEM on the TPU, registers here) across every turn.
//
// Two variants:
//   FMA = false: a separate multiply and add per chain step (__fmul_rn,
//                __fadd_rn), the rounding the step kernels use (they build
//                with -fmad=false).
//   FMA = true:  one __fmaf_rn per chain step, which -fmad=false does not
//                split.
//
// What bounds it: nothing but the FP32 pipes.  No memory traffic inside
// the turns (one read and one write per element per launch).  The
// coefficients arrive as a device array, so nvcc can neither fold nor
// hoist the chain, and each thread loads all 2·K of them into registers
// once: the turn loop is then FMUL and FADD (or FFMA) on registers and
// the loop's own counter and branch, nothing else.  Taken from the
// constant bank instead, they cost nvcc's uniform loads (ULDC.64) inside
// the loop, one per pair of values.  Each thread carries ILP independent
// elements (element t + j *
// threads for j < ILP, so a warp's loads and stores stay coalesced).
// vpu_roofline.py times every (ILP, block size) pair it was built for.

#include <cuda_runtime.h>

namespace {

constexpr int K = 64;   // chain steps per turn (vpu_roofline.py K)

template <int ILP, bool FMA>
__global__ void vpu_chain(const float* __restrict__ x, float* __restrict__ y,
                          const float* __restrict__ coef,
                          const float* __restrict__ bias, int n, int reps) {
  const int threads = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float c[K], b[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c[k] = __ldg(coef + k);
    b[k] = __ldg(bias + k);
  }
  float v[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const int i = t + j * threads;
    v[j] = i < n ? x[i] : 0.0f;
  }
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        v[j] = FMA ? __fmaf_rn(v[j], c[k], b[k])
                   : __fadd_rn(__fmul_rn(v[j], c[k]), b[k]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const int i = t + j * threads;
    if (i < n) y[i] = v[j];
  }
}

template <int ILP, bool FMA>
int launch(const float* x, float* y, const float* coef, const float* bias,
           int n, int reps, int block, cudaStream_t s) {
  const int threads = (n + ILP - 1) / ILP;
  const int grid = (threads + block - 1) / block;
  vpu_chain<ILP, FMA><<<grid, block, 0, s>>>(x, y, coef, bias, n, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes in perf/vpu_roofline.py).  x, y: n
// device floats; coef, bias: K device floats each.  ilp is 2 or 4; fma 0
// or 1.  One launch on `stream`, no synchronisation; returns 0 or the
// cudaError_t (cudaErrorInvalidValue for an ilp it was not built for).
extern "C" int slb_vpu_chain_f32(const void* x, void* y, const void* coef,
                                 const void* bias, int n, int reps, int ilp,
                                 int fma, int block, void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const float* cf = static_cast<const float*>(coef);
  const float* bf = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ilp * 2 + (fma ? 1 : 0)) {
    case 4: return launch<2, false>(xf, yf, cf, bf, n, reps, block, s);
    case 5: return launch<2, true>(xf, yf, cf, bf, n, reps, block, s);
    case 8: return launch<4, false>(xf, yf, cf, bf, n, reps, block, s);
    case 9: return launch<4, true>(xf, yf, cf, bf, n, reps, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
