// The ExSample Thompson chunk choice: the Wilson-Hilferty Gamma draw and the
// per-cohort argmax, in two forms.
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
// B2 runs the same body over Q queries x C cohorts, row r reading query
// r / C's statistics.  wh_draw is the draw of both kernels below: every
// operation an explicitly rounded intrinsic in the reference's order, so
// nvcc cannot contract or reassociate and the value equals the plain
// PyTorch version bit for bit.
//
// thompson_choose_kernel: the 1:1 counterpart of the Pallas signature, z
// given.  One block a cohort row; threads stride over M keeping a private
// (value, index) best, then a warp-shuffle and shared-memory reduction in
// which the larger value wins and, on equal values, the lower index.  No
// main path launches it since the fused kernel below; the kernel phase and
// the card tests keep holding it.
//
// thompson_round_kernel: the whole Thompson decision of a round, from the
// choice key to the chunk ids, in one launch, as the reference's driver
// composes it (src/repro/core/thompson.py::choose_chunks, method "pallas":
// gamma_params, jax.random.normal(key, (C, M)), then B1; batched: vmap of
// the normal over Q keys, then B2).  Per element (c, j) of query q:
//   * alpha = max(n1[j] + alpha0, alpha0/2), beta = n[j] + beta0, exhausted
//     = n[j] >= frames[j] (as float32), each rounded as PyTorch rounds a
//     float32 tensor plus a float32 scalar; an exhausted or alpha <= 0 chunk
//     is skipped (its score, -1e30, never beats the start);
//   * the normal from JAX's partitionable threefry2x32 stream: counter
//     c*M + j with a high word of 0, 20 rounds in uint32 registers
//     (__funnelshift_l rotations), bits = hi ^ lo, the mantissa trick, the
//     uniform's FMA and clamp at nextafter(-1, 0), then sqrt(2) * ErfInv
//     with XLA CPU's log1p and log and XLA's ErfInv polynomial.  Each
//     multiply-add that XLA contracts is __fmaf_rn (one rounding, as
//     repro_torch/numerics.py's fma32 emulates) and every other operation a
//     rounded intrinsic, so the normal equals repro_torch/core/prng.py's bit
//     for bit;
//   * wh_draw, and a running first maximum.
// Nothing of size C*M touches memory: the kernel reads the key (int64[2] a
// query, two uint32 words) and the statistics (12 B a chunk) and writes 8 B
// a row.  The key is read from device memory, so a captured CUDA graph
// replays the launch with each round's new key.
// Spread: each cohort row is a thread-block cluster of S blocks (1 to 8;
// the wrapper's rule fills the SMs: S = 3 at the scan's (50, 1000), 1 at the
// multi path's 400 rows), block s owning the contiguous chunks
// [s*ceil(M/S), (s+1)*ceil(M/S)).  Each block reduces (value, index) pairs
// lexicographically with warp shuffles, then in shared memory; rank 0 reads
// the S partials through distributed shared memory in rank order and
// writes the row.  Any split gives the unsplit first maximum, ties at 0
// (a fresh chunk draws exactly 0 about half the time) included.
//
// Bound on the H100.  thompson_choose: bytes, 8QM + 4QCM + 8QC (0.50 us at
// (8, 50, 1000) and 3.35 TB/s), so one launch is bound by launch latency.
// thompson_round: operations, ~150 a live element (threefry's 72 integer
// operations, the log and ErfInv polynomials, three divisions and two
// square roots; chip_smoke.py counts them for the run's data), 50,000
// elements at (50, 1000): ~0.2 us of issue against 0.004 us of bytes.  At
// the main path's shapes a cluster launch's fixed cost dominates; the gain
// is the ~840 launches of the normal, and z's round trip through HBM, that
// it replaces.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRoundThreads = 256;
constexpr int kMaxSplits = 8;              // blocks a row: one portable cluster
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Float32 constants of repro_torch/core/prng.py, each the exact value of its
// _f32(...) as a hexadecimal literal.
constexpr float kUniformLo = -0x1.fffffep-1f;     // nextafter(-1, 0)
constexpr float kUniformSpan = 0x1p+1f;           // float32(1 - lo) = 2
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kMinNormal = 0x1p-126f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kLogQ1 = -0x1.bd0106p-13f;
constexpr float kLogQ2 = 0x1.63p-1f;
constexpr float kLog1pSmall = 0x1.a8279ap-2f;    // sqrt(2) - 1
__constant__ float kLogP[9] = {
    0x1.204376p-4f, -0x1.d7a370p-4f, 0x1.de4a34p-4f, -0x1.fcba9ep-4f, 0x1.23d37ep-3f,
    -0x1.555ca0p-3f, 0x1.999d58p-3f, -0x1.fffff8p-3f, 0x1.555554p-2f};
__constant__ float kLog1pNum[7] = {
    0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f, 0x1.e798ecp+5f,
    0x1.c8e75ap+5f, 0x1.40a202p+4f};
__constant__ float kLog1pDen[7] = {
    0x1p+0f, 0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f, 0x1.351946p+8f,
    0x1.b0db14p+7f, 0x1.e0f304p+5f};
__constant__ float kErfinvLt5[9] = {
    0x1.e2cb10p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f, -0x1.26b582p-18f, 0x1.ca65b6p-13f,
    -0x1.48a810p-10f, -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
__constant__ float kErfinvGe5[9] = {
    -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f, -0x1.e17bcep-9f, 0x1.7824f6p-8f,
    -0x1.f38baep-8f, 0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};

__device__ __forceinline__ void keep_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// The first maximum (value, index) of the block's threads, in warp 0.
__device__ __forceinline__ void block_first_max(float& bv, int& bi, float* sv, int* si, int nwarps) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, bv, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    keep_better(bv, bi, ov, oi);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < nwarps ? sv[lane] : kNegInf;
    bi = lane < nwarps ? si[lane] : -1;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, bv, off);
      const int oi = __shfl_down_sync(kFull, bi, off);
      keep_better(bv, bi, ov, oi);
    }
  }
}

// a * max(1 - 1/(9a) + z/(3 sqrt(a)), 0)^3 / max(beta, 1e-9), a = max(alpha, 1e-6),
// in repro_torch/core/thompson.py::wilson_hilferty's order (alpha > 0).
__device__ __forceinline__ float wh_draw(float alpha, float beta, float z) {
  const float a = fmaxf(alpha, 1e-6f);
  const float r = __fdiv_rn(1.0f, __fmul_rn(a, 9.0f));
  const float q = __fdiv_rn(z, __fmul_rn(__fsqrt_rn(a), 3.0f));
  const float c = fmaxf(__fadd_rn(__fsub_rn(1.0f, r), q), 0.0f);
  const float cube = __fmul_rn(__fmul_rn(c, c), c);
  return __fdiv_rn(__fmul_rn(a, cube), fmaxf(beta, 1e-9f));
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
    const float draw = wh_draw(al, beta[j], zr[j]);
    if (draw > bv) {  // j grows within a thread: strict '>' keeps the first
      bv = draw;
      bi = j;
    }
  }
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  block_first_max(bv, bi, sv, si, kThreads / 32);
  if (threadIdx.x == 0) {
    idx[row] = bi;
    val[row] = bv;
  }
}

// ---- the key stream: repro_torch/core/prng.py, one element in registers

__device__ __forceinline__ int rotation(int i, int k) {   // prng._ROT[i % 2][k]
  return (i & 1) ? (k == 0 ? 17 : k == 1 ? 29 : k == 2 ? 16 : 24)
                 : (k == 0 ? 13 : k == 1 ? 15 : k == 2 ? 26 : 6);
}

// threefry2x32 of the counter (0, lo) under key (k0, k1), ks2 = k0^k1^0x1BD11BDA;
// returns hi ^ lo, random_bits' 32-bit word.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t ks2,
                                                  uint32_t lo) {
  const uint32_t ks[3] = {k0, k1, ks2};
  uint32_t x0 = k0;          // high count word 0, plus k0
  uint32_t x1 = lo + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(i, k)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

// prng._xla_log_f32: XLA CPU's float32 log.
__device__ __forceinline__ float xla_log(float t) {
  t = t < kMinNormal ? kMinNormal : t;
  const int bits = __float_as_int(t);
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);   // [0.5, 1)
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  const bool small = m < kSqrtHalf;
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float y = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float z = __fmul_rn(y, y);
  const float y3 = __fmul_rn(z, y);
  const float q1 = __fmaf_rn(__fmaf_rn(y, kLogP[0], kLogP[1]), y, kLogP[2]);
  const float q2 = __fmaf_rn(__fmaf_rn(y, kLogP[3], kLogP[4]), y, kLogP[5]);
  const float q3 = __fmaf_rn(__fmaf_rn(y, kLogP[6], kLogP[7]), y, kLogP[8]);
  const float r = __fmaf_rn(q1, y3, q2);
  const float s = __fmaf_rn(r, y3, q3);
  const float u = __fmaf_rn(s, y3, __fmul_rn(e, kLogQ1));
  const float v = __fsub_rn(y, __fmul_rn(z, 0.5f));
  return __fadd_rn(__fadd_rn(v, u), __fmul_rn(e, kLogQ2));
}

// prng._xla_log1p_f32: a rational approximation below sqrt(2) - 1, log(1 + x) above.
__device__ __forceinline__ float xla_log1p(float x) {
  if (!(fabsf(x) < kLog1pSmall)) return xla_log(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float num = kLog1pNum[0], den = kLog1pDen[0];
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    num = __fmaf_rn(num, x, kLog1pNum[k]);
    den = __fmaf_rn(den, x, kLog1pDen[k]);
  }
  const float ratio = __fdiv_rn(num, den);
  return __fadd_rn(x, __fadd_rn(__fmul_rn(x2, -0.5f), __fmul_rn(__fmul_rn(x, x2), ratio)));
}

// prng.erfinv_f32: XLA's float32 ErfInv.
__device__ __forceinline__ float xla_erfinv(float x) {
  float w = -xla_log1p(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? kErfinvLt5[0] : kErfinvGe5[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) p = __fmaf_rn(p, w, lt ? kErfinvLt5[k] : kErfinvGe5[k]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, CUDART_INF_F) : __fmul_rn(p, x);
}

// prng.normal of random_bits word ``bits``.
__device__ __forceinline__ float normal_of(uint32_t bits) {
  const float unit = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  float u = __fmaf_rn(unit, kUniformSpan, kUniformLo);
  u = u < kUniformLo ? kUniformLo : u;
  return __fmul_rn(xla_erfinv(u), kSqrt2);
}

// One cohort row a cluster of ``splits`` blocks (the launch's cluster size);
// row r = blockIdx.x / splits is cohort r % cohorts of query r / cohorts.
__global__ void __launch_bounds__(kRoundThreads, 1)
thompson_round_kernel(const long long* __restrict__ keys, long long key_stride,
                      const float* __restrict__ n1, const float* __restrict__ n,
                      const int* __restrict__ frames, float alpha0, float alpha_floor,
                      float beta0, int cohorts, int m, int* __restrict__ idx,
                      float* __restrict__ val) {
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / splits;
  const int q = row / cohorts;
  const uint32_t k0 = static_cast<uint32_t>(keys[q * key_stride]);
  const uint32_t k1 = static_cast<uint32_t>(keys[q * key_stride + 1]);
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const size_t q_off = static_cast<size_t>(q) * m;
  n1 += q_off;
  n += q_off;
  frames += q_off;
  const int piece = (m + splits - 1) / splits;
  const int lo = min(m, rank * piece), hi = min(m, lo + piece);
  const uint32_t count0 = static_cast<uint32_t>(row - q * cohorts) * static_cast<uint32_t>(m);
  float bv = kNegInf;
  int bi = -1;
  for (int j = lo + threadIdx.x; j < hi; j += kRoundThreads) {
    const float nj = n[j];
    if (nj >= __int2float_rn(frames[j])) continue;          // exhausted
    float al = __fadd_rn(n1[j], alpha0);
    al = al < alpha_floor ? alpha_floor : al;               // torch.clamp_min
    if (!(al > 0.0f)) continue;
    const float z = normal_of(threefry_bits(k0, k1, ks2, count0 + static_cast<uint32_t>(j)));
    const float draw = wh_draw(al, __fadd_rn(nj, beta0), z);
    if (draw > bv) {  // j grows within a thread: strict '>' keeps the first
      bv = draw;
      bi = j;
    }
  }
  __shared__ float sv[kRoundThreads / 32];
  __shared__ int si[kRoundThreads / 32];
  __shared__ float part_v;   // the block's first maximum, read by rank 0
  __shared__ int part_i;
  block_first_max(bv, bi, sv, si, kRoundThreads / 32);
  if (splits == 1) {
    if (threadIdx.x == 0) {
      idx[row] = bi;
      val[row] = bv;
    }
    return;
  }
  if (threadIdx.x == 0) {
    part_v = bv;
    part_i = bi;
  }
  cluster.sync();                            // every block's partial is in
  if (rank == 0 && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    bv = lane < splits ? *cluster.map_shared_rank(&part_v, lane) : kNegInf;
    bi = lane < splits ? *cluster.map_shared_rank(&part_i, lane) : -1;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, bv, off);
      const int oi = __shfl_down_sync(kFull, bi, off);
      keep_better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      idx[row] = bi;
      val[row] = bv;
    }
  }
  cluster.sync();                            // no block's shared memory is read any more
}

cudaError_t launch_round(const long long* keys, long long key_stride, const float* n1,
                         const float* n, const int* frames, float alpha0, float alpha_floor,
                         float beta0, int q, int c, int m, int splits, int* idx, float* val,
                         cudaStream_t stream) {
  if (q <= 0 || c <= 0) return cudaSuccess;
  if (m <= 0 || splits < 1 || splits > kMaxSplits ||
      static_cast<long long>(q) * c * splits >= (1LL << 31) ||
      static_cast<long long>(c) * m >= (1LL << 32))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(q * c * splits));
  cfg.blockDim = dim3(kRoundThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];                // the splits of a row form one cluster
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, thompson_round_kernel, keys, key_stride, n1, n,
                                             frames, alpha0, alpha_floor, beta0, c, m, idx, val);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// The fused round for Q queries: keys int64[q, 2] (two uint32 words a row,
// row stride key_stride elements); n1, n f32[q, m] and frames i32[q, m]
// contiguous; alpha0, alpha_floor (alpha0 / 2) and beta0 as float32; splits
// 1 to 8 blocks a row.  idx i32[q, c], val f32[q, c].  One launch on
// ``stream``; returns its CUDA status (0 on success).
extern "C" int thompson_round_batched_f32(const long long* keys, long long key_stride,
                                          const float* n1, const float* n, const int* frames,
                                          float alpha0, float alpha_floor, float beta0, int q,
                                          int c, int m, int splits, int* idx, float* val,
                                          void* stream) {
  return static_cast<int>(launch_round(keys, key_stride, n1, n, frames, alpha0, alpha_floor, beta0,
                                       q, c, m, splits, idx, val,
                                       static_cast<cudaStream_t>(stream)));
}

// The fused round for one query: key int64[2]; n1, n f32[m], frames i32[m];
// idx i32[c], val f32[c].  As above with q = 1.
extern "C" int thompson_round_f32(const long long* key, const float* n1, const float* n,
                                  const int* frames, float alpha0, float alpha_floor, float beta0,
                                  int c, int m, int splits, int* idx, float* val, void* stream) {
  return static_cast<int>(launch_round(key, 0, n1, n, frames, alpha0, alpha_floor, beta0, 1, c, m,
                                       splits, idx, val, static_cast<cudaStream_t>(stream)));
}
