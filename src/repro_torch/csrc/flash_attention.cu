// Causal or full GQA attention forward (prefill) with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention (body _fwd_kernel): for batch b, query head h and row i,
//     s[j] = (q[b,i,h,:] . k[b,j,kv,:]) * scale,  scale = 1/sqrt(d),
//     kv   = h / (H / KV)                          (GQA by index, no repeat)
//     s[j] = -1e30 where causal and i < j           (top-left diagonal)
//     out[b,i,h,:] = sum_j softmax(s)[j] v[b,j,kv,:]
// with float32 scores, maxima, sums and accumulators whatever the input type
// (float32 or bfloat16), the output in the input type, and the final
// division by max(l, 1e-30) as in the TPU kernel.  The causal rule is the
// TPU kernel's (row >= column, counted from the top left), also when the
// query and key lengths differ.
//
// Design: one block of 128 threads per (query tile of BQ rows, batch*head).
// q, k and v are read in their [B, S, H, d] / [B, T, KV, d] layouts through
// their strides, so nothing is transposed or repeated in device memory.  The
// block stages its Q tile once, then walks the K/V tiles in order: each is
// staged in shared memory (converted to float32), the BQ x BK scores go to
// shared memory, one thread per row updates that row's running maximum and
// sum and leaves exp(s - m) in place, and every thread rescales and adds to
// its 4 rows x DMAX/CG output columns held in registers.  Causal blocks skip
// the K/V tiles wholly above the diagonal (first column > last row of the
// tile), as the TPU kernel does; the heaviest query tiles are scheduled
// first.  Ragged S and T are handled by bounds: rows past S are computed on
// zeros and never written, columns past T get weight 0.  Q and K rows are
// stored with an odd stride (d + 1) so the score loop reads shared memory
// without bank conflicts.  d must be a multiple of 8 (16-byte loads) and at
// most 256; the tile shapes are chosen by d's bucket (64, 128, 256).
//
// Bound on the H100: at the serve path's prefill (B, S, H, KV, d) =
// (4, 2048, 40, 10, 128), causal, float32, one launch reads q, k, v once and
// writes out (4*2048*(40+10+10+40)*128*4 B = 419 MB, 0.13 ms at 3.35 TB/s)
// and does 4*d flops per live (row, column) pair (1.72e11 flops, 2.57 ms at
// 67 TFLOP/s of float32): it is bound by arithmetic.  This first version
// runs that arithmetic as float32 FMAs on the CUDA cores, not on the tensor
// cores (no wgmma, no TMA); making it fast is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
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

template <int DMAX> struct Tiles;
template <> struct Tiles<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 64, BK = 32; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

template <int DMAX>
size_t smem_bytes(int d) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  return sizeof(float) * (static_cast<size_t>(BQ) * (d + 1) + static_cast<size_t>(BK) * (d + 1) +
                          static_cast<size_t>(BK) * d + BQ * (BK + 1) + BQ);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int S, int Tk, int H, int KV, int d,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       int causal, float scale) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  constexpr int TR = 4;                 // rows per thread
  constexpr int RG = BQ / TR;           // row groups
  constexpr int CG = kThreads / RG;     // column groups
  constexpr int SC = BK / CG;           // score columns per thread
  constexpr int OC = DMAX / CG;         // output columns per thread
  static_assert(RG * CG == kThreads && SC * CG == BK && OC * CG == DMAX, "tile shape");

  extern __shared__ float smem[];
  const int ldq = d + 1;
  float* sQ = smem;                     // [BQ][d + 1]
  float* sK = sQ + BQ * ldq;            // [BK][d + 1]
  float* sV = sK + BK * ldq;            // [BK][d]
  float* sS = sV + BK * d;              // [BQ][BK + 1]
  float* sRow = sS + BQ * (BK + 1);     // [BQ]: alpha per tile, then max(l, 1e-30)

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int q_tile = gridDim.x - 1 - blockIdx.x;    // heaviest causal tiles first
  const int q0 = q_tile * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  load_tile(sQ, ldq, qb, q_ss, q0, BQ, S, d);

  float acc[TR][OC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[r][c] = 0.f;
  float m_row = kNegInf, l_row = 0.f;   // row tid's running max and sum (tid < BQ)

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                    // the previous tile's readers are done
    load_tile(sK, ldq, kb, k_st, k0, BK, Tk, d);
    load_tile(sV, d, vb, v_st, k0, BK, Tk, d);
    __syncthreads();

    float sc[TR][SC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) sc[r][c] = 0.f;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      float qa[TR], kk[SC];
#pragma unroll
      for (int r = 0; r < TR; ++r) qa[r] = sQ[(rg * TR + r) * ldq + e];
#pragma unroll
      for (int c = 0; c < SC; ++c) kk[c] = sK[(cg + c * CG) * ldq + e];
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < SC; ++c) sc[r][c] = fmaf(qa[r], kk[c], sc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = q0 + rg * TR + r;
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const int col = k0 + cg + c * CG;
        float s;
        if (col >= Tk) s = __int_as_float(0xff800000);     // -inf: no such key, weight 0
        else if (causal && row < col) s = kNegInf;
        else s = sc[r][c] * scale;
        sS[(rg * TR + r) * (BK + 1) + cg + c * CG] = s;
      }
    }
    __syncthreads();

    if (tid < BQ) {
      float* srow = sS + tid * (BK + 1);
      float mx = kNegInf;
      for (int j = 0; j < BK; ++j) mx = fmaxf(mx, srow[j]);
      const float m_new = fmaxf(m_row, mx);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum += p;
      }
      const float alpha = expf(m_row - m_new);
      l_row = l_row * alpha + sum;
      m_row = m_new;
      sRow[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float a = sRow[rg * TR + r];
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[r][c] *= a;
    }
    for (int j = 0; j < BK; ++j) {
      float p[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) p[r] = sS[(rg * TR + r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int col = cg + c * CG;
        if (col < d) {
          const float vv = sV[j * d + col];
#pragma unroll
          for (int r = 0; r < TR; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
        }
      }
    }
  }

  __syncthreads();
  if (tid < BQ) sRow[tid] = fmaxf(l_row, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = q0 + rg * TR + r;
    if (row >= S) continue;
    const float denom = sRow[rg * TR + r];
    T* orow = out + ((static_cast<long long>(b) * S + row) * H + h) * d;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = cg + c * CG;
      if (col < d) store1(orow + col, acc[r][c] / denom);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                   int H, int KV, int d, const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DMAX>;
  const size_t smem = smem_bytes<DMAX>(d);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + Tiles<DMAX>::BQ - 1) / Tiles<DMAX>::BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Tk, H, KV, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                       int H, int KV, int d, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, out, B, S, Tk, H, KV, d, st, causal, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, out, B, S, Tk, H, KV, d, st, causal, scale, stream);
  return launch<T, 256>(q, k, v, out, B, S, Tk, H, KV, d, st, causal, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q [B,S,H,d], k/v [B,T,KV,d] with unit last
// stride; strides in elements: q (batch, seq, head), k (batch, seq, head),
// v (batch, seq, head).  out is a contiguous [B,S,H,d] of the same type.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int Tk, int H, int KV, int d,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh,
                                   int causal, float scale, void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || KV <= 0 || H % KV != 0 || B * H > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch_d<float>(q, k, v, out, B, S, Tk, H, KV, d, st, causal, scale, s)
                 : dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, KV, d, st, causal, scale, s);
  return static_cast<int>(err);
}
