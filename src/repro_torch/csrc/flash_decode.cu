// One query token per sequence against a KV cache (decode attention).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py::
// flash_decode (body _decode_kernel): for batch b and KV head kv, the
// G = H / KV query heads h = kv*G + g share the cache's head kv, and
//     s[t] = (q[b,h,:] . k[b,t,kv,:]) * scale,  scale = 1/sqrt(d),
//     s[t] = -1e30 where t >= cache_len[b],
//     out[b,h,:] = (sum_t exp(s[t] - m) v[b,t,kv,:]) / max(sum_t exp(s[t] - m), 1e-30)
// with an online softmax over the cache in float32 whatever the input type
// (float32 or bfloat16), and the output in the input type.
//
// Design: one block of 256 threads per (batch, KV head), carrying the G
// heads of the group.  The block stages q once, then walks the cache in
// blocks of 64 positions: each K/V block is staged in shared memory
// (converted to float32, K rows at an odd stride so the score loop has no
// bank conflicts), the G x 64 scores go to shared memory, one thread per
// head updates that head's running maximum and sum, and the threads add
// the weighted V rows into the G x d accumulators they own.  Cache blocks
// wholly at or past cache_len[b] are skipped: there every weight is
// exp(-1e30 - m) = 0 and the rescale factor is 1, so skipping is exact.  The
// exception is cache_len = 0, where every score is -1e30, every weight is
// exp(0) = 1 and the reference returns the mean of V over all T positions:
// then every block is read.  Positions past T (a ragged last block) get
// weight 0.  The cache is read through its strides, so a [B, T, KV, d]
// cache is never transposed.  d must be a multiple of 8, at most 256.
//
// Bound on the H100: the kernel must read q and the live part of the
// cache once and write out.  At (B, H, KV, d, T) = (8, 40, 10, 128, 32768)
// with full caches in float32 that is 2.68 GB, 0.80 ms at 3.35 TB/s, and
// 4*d flops per head and live position (0.08 ms at 67 TFLOP/s of float32):
// it is bound by bytes.  One block per (b, kv) gives B*KV blocks: 40 at the
// serve path's (4, 10), on 132 SMs, so at most 40 SMs stream the cache.  A
// split over the cache's length, with a combine of the partial softmaxes,
// is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockT = 64;             // cache positions per staged block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Rows r0 .. r0+nrows-1 of a [rows, d] view (row stride in elements) into
// shared memory with row stride ld, as float32; rows at or past n_valid are
// zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long row_stride,
                                          int r0, int nrows, int n_valid, int d) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    float vals[8];
    if (r0 + r < n_valid) {
      load8(src + static_cast<long long>(r0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * ld + c + j] = vals[j];
  }
}

// Above the card's 227 KB per block (e.g. 48 heads of 256), the attribute
// call below fails and the launch returns its error.
size_t smem_floats(int G, int d) {
  return static_cast<size_t>(G) * d            // q
         + static_cast<size_t>(kBlockT) * (d + 1)  // K block
         + static_cast<size_t>(kBlockT) * d        // V block
         + static_cast<size_t>(G) * (kBlockT + 1)  // scores, then weights
         + static_cast<size_t>(G) * d              // accumulators
         + 3 * static_cast<size_t>(G);             // max, sum, rescale per head
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ cache_len, T* __restrict__ out,
                    int Tc, int H, int KV, int d,
                    long long q_sb, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh, float scale) {
  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  const int ldk = d + 1;
  float* sQ = smem;                           // [G][d]
  float* sK = sQ + G * d;                     // [kBlockT][d + 1]
  float* sV = sK + kBlockT * ldk;             // [kBlockT][d]
  float* sS = sV + kBlockT * d;               // [G][kBlockT + 1]
  float* sAcc = sS + G * (kBlockT + 1);       // [G][d]
  float* sM = sAcc + G * d;                   // [G]
  float* sL = sM + G;                         // [G]
  float* sAlpha = sL + G;                     // [G]

  load_tile(sQ, d, q + b * q_sb + static_cast<long long>(kvh) * G * q_sh, q_sh, 0, G, G, d);
  for (int i = tid; i < G * d; i += kThreads) sAcc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  const T* kb = kc + b * k_sb + kvh * k_sh;
  const T* vb = vc + b * v_sb + kvh * v_sh;
  const int len = cache_len[b];
  int n_blocks = (Tc + kBlockT - 1) / kBlockT;
  if (len > 0) n_blocks = min(n_blocks, (len + kBlockT - 1) / kBlockT);

  for (int kt = 0; kt < n_blocks; ++kt) {
    const int t0 = kt * kBlockT;
    __syncthreads();                          // the previous block's readers are done
    load_tile(sK, ldk, kb, k_st, t0, kBlockT, Tc, d);
    load_tile(sV, d, vb, v_st, t0, kBlockT, Tc, d);
    __syncthreads();

    for (int i = tid; i < G * kBlockT; i += kThreads) {
      const int g = i / kBlockT, j = i - g * kBlockT;
      const int pos = t0 + j;
      float s;
      if (pos >= Tc) {
        s = __int_as_float(0xff800000);      // -inf: no such position, weight 0
      } else if (pos >= len) {
        s = kNegInf;
      } else {
        const float* qg = sQ + g * d;
        const float* kr = sK + j * ldk;
        float dot = 0.f;
#pragma unroll 8
        for (int e = 0; e < d; ++e) dot = fmaf(qg[e], kr[e], dot);
        s = dot * scale;
      }
      sS[g * (kBlockT + 1) + j] = s;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      float* srow = sS + g * (kBlockT + 1);
      float mx = kNegInf;
      for (int j = 0; j < kBlockT; ++j) mx = fmaxf(mx, srow[j]);
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = 0; j < kBlockT; ++j) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_new);
      sL[g] = sL[g] * alpha + sum;
      sM[g] = m_new;
      sAlpha[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < G * d; i += kThreads) {
      const int g = i / d, c = i - g * d;
      const float* prow = sS + g * (kBlockT + 1);
      float a = sAcc[i] * sAlpha[g];
#pragma unroll 8
      for (int j = 0; j < kBlockT; ++j) a = fmaf(prow[j], sV[j * d + c], a);
      sAcc[i] = a;
    }
  }

  __syncthreads();
  T* ob = out + (static_cast<long long>(b) * H + static_cast<long long>(kvh) * G) * d;
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d;
    store1(ob + i, sAcc[i] / fmaxf(sL[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* cache_len, void* out,
                   int B, int Tc, int H, int KV, int d, const long long* st, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T>;
  const size_t smem = sizeof(float) * smem_floats(H / KV, d);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), cache_len,
      static_cast<T*>(out), Tc, H, KV, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q [B,H,d] with strides (batch, head) in
// elements and unit last stride; caches [B,T,KV,d] with strides (batch,
// position, head); cache_len int32[B]; out a contiguous [B,H,d] of q's
// type.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_decode_fwd(int dtype, const void* q, const void* k, const void* v,
                                const void* cache_len, void* out, int B, int Tc, int H, int KV,
                                int d, long long q_sb, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh,
                                long long v_sb, long long v_st, long long v_sh,
                                float scale, void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(cache_len);
  const cudaError_t err =
      dtype == 0 ? launch<float>(q, k, v, lens, out, B, Tc, H, KV, d, st, scale, s)
                 : launch<__nv_bfloat16>(q, k, v, lens, out, B, Tc, H, KV, d, st, scale, s);
  return static_cast<int>(err);
}
