// Fused Wilson-Hilferty Thompson draw + per-cohort argmax for the ExSample
// chunk choice.
//
// Replaces the TPU kernels src/repro/kernels/thompson/kernel.py::thompson_choose
// (B1) and ::thompson_choose_batched (B2), which share the body
// _thompson_kernel: for cohort row c and chunk j
//     a     = max(alpha[j], 1e-6)
//     draw  = a * max(1 - 1/(9a) + z[c,j]/(3*sqrt(a)), 0)^3 / max(beta[j], 1e-9)
//     score = alpha[j] > 0 ? draw : -1e30          (alpha <= 0: exhausted)
// and returns the first index of the row maximum with its value.  The TPU
// kernel walks M in blocks in order (first index within a block, strict '>'
// across blocks), so an all-exhausted row keeps its initial (-1, -1e30).
//
// B2 runs the same body over Q queries x C cohorts: Q*C rows in one launch,
// row r reading query r / C's alpha/beta row and z row r.  B1 is the case
// Q = 1.
//
// Design: one block per cohort row; threads stride over M keeping a private
// (value, index) best in registers, then a warp-shuffle and shared-memory
// reduction in which the larger value wins and, on equal values, the lower
// index.  That reproduces "earliest index wins" without a sequential grid,
// and nothing of size M is ever written to device memory.  Every operation
// is an explicitly rounded intrinsic (__fmul_rn, __fdiv_rn, __fsqrt_rn, ...)
// in the reference's order, so nvcc cannot contract or reassociate and the
// value equals the plain PyTorch version bit for bit.
//
// Bound on the H100: the kernel reads alpha and beta (8 B per chunk) and z
// (4 B per chunk and row) once and writes 8 B per row: at the main path's
// C=50 rows and M=22 (dashcam) to 1,000 (bdd) chunks that is 4.6 KB to
// 208 KB, under 0.1 us at 3.35 TB/s, and ~10 flops per element.  One
// launch is therefore bound by launch latency, not by HBM or arithmetic;
// the design keeps it to one launch per Thompson round.  B2 at the multi
// path's (Q, C, M) = (8, 50, 1000) moves 8QM + 4QCM + 8QC = 1.67 MB (0.50
// us at 3.35 TB/s; 14 flops per live element, 0.08 us at 67 TFLOP/s), so
// it too is bound by the launch, once per multi-query round.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void keep_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __launch_bounds__(kThreads)
thompson_choose_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
                       const float* __restrict__ z, int rows_per_query, int m,
                       int* __restrict__ idx, float* __restrict__ val) {
  const int row = blockIdx.x;
  const float* zr = z + static_cast<size_t>(row) * m;
  const size_t q_off = static_cast<size_t>(row / rows_per_query) * m;   // this row's query
  alpha += q_off;
  beta += q_off;
  float bv = kNegInf;
  int bi = -1;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float al = alpha[j];
    if (!(al > 0.0f)) continue;  // masked score -1e30 never beats the start
    const float a = fmaxf(al, 1e-6f);
    const float r = __fdiv_rn(1.0f, __fmul_rn(a, 9.0f));
    const float q = __fdiv_rn(zr[j], __fmul_rn(__fsqrt_rn(a), 3.0f));
    const float c = fmaxf(__fadd_rn(__fsub_rn(1.0f, r), q), 0.0f);
    const float cube = __fmul_rn(__fmul_rn(c, c), c);
    const float draw = __fdiv_rn(__fmul_rn(a, cube), fmaxf(beta[j], 1e-9f));
    if (draw > bv) {  // j grows within a thread: strict '>' keeps the first
      bv = draw;
      bi = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    keep_better(bv, bi, ov, oi);
  }
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kThreads / 32 ? sv[lane] : kNegInf;
    bi = lane < kThreads / 32 ? si[lane] : -1;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      keep_better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      idx[row] = bi;
      val[row] = bv;
    }
  }
}

}  // namespace

// alpha, beta: f32[m]; z: f32[c, m] row-major; idx: i32[c]; val: f32[c].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int thompson_choose_f32(const float* alpha, const float* beta, const float* z,
                                   int c, int m, int* idx, float* val, void* stream) {
  if (c <= 0) return 0;
  thompson_choose_kernel<<<c, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      alpha, beta, z, c, m, idx, val);
  return static_cast<int>(cudaGetLastError());
}

// alpha, beta: f32[q, m]; z: f32[q, c, m] row-major; idx: i32[q, c];
// val: f32[q, c].  Returns cudaGetLastError() after the launch.
extern "C" int thompson_choose_batched_f32(const float* alpha, const float* beta,
                                           const float* z, int q, int c, int m, int* idx,
                                           float* val, void* stream) {
  if (q <= 0 || c <= 0) return 0;
  thompson_choose_kernel<<<q * c, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      alpha, beta, z, c, m, idx, val);
  return static_cast<int>(cudaGetLastError());
}
