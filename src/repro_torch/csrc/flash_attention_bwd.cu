// The backward of causal or full GQA attention: (dQ, dK, dV) from Q, K, V,
// the forward's output O and the output's gradient dO, float32.
//
// Replaces no TPU kernel.  It is the gradient of the function kernel B4
// (csrc/flash_attention.cu, after src/repro/kernels/flash_attention/kernel.py::
// flash_attention) computes, which the reference's training gets from
// jax.grad of its plain-jnp blocked_attention (src/repro/models/attention.py,
// through jax.value_and_grad in src/repro/train/train_step.py): none of the
// reference's Pallas kernels has a backward.  The port's forward runs B4 on
// the card, which writes its output through ctypes and so has no autograd
// graph; kernels/flash_attention/ops.py wraps B4 and this kernel in one
// torch.autograd.Function, so no attention layer cuts a gradient.
//
// For batch b, query head h (KV head kv = h / (H / KV), GQA by index) and the
// forward's rule (scale = 1/sqrt(d); row i sees column j iff i >= j when
// causal, counted from the top left, also when S != T; columns past T do not
// exist):
//     P[i,j]  = exp(s[i,j]*scale - lse[i]),  s = Q.K^T,  lse = log sum_j exp(s*scale)
//     D[i]    = sum_c dO[i,c] O[i,c]          (= sum_j P[i,j] dP[i,j])
//     dP[i,j] = dO[i] . V[j],   dS[i,j] = P[i,j] (dP[i,j] - D[i])
//     dQ[i]   = scale * sum_j dS[i,j] K[j]
//     dK[j]   = scale * sum_{h of kv} sum_i dS[i,j] Q[i],   dV[j] = sum_{h of kv} sum_i P[i,j] dO[i]
// A masked pair has P = 0 exactly (the forward's exp(-1e30 - m)).
//
// Three launches on the caller's stream, float32 FMAs on the CUDA cores, no
// atomics, so the result is the same bits every run:
//   1. flash_attention_bwd_prep, a block per (BT query rows, b*H + h): D of each row
//      (a warp a row, coalesced), then lse recomputed from Q.K^T with the
//      forward's online maximum and sum; B4's bodies and their launch counts
//      stay as they are.  lse and D go to [B, H, S] float32 scratch.
//   2. flash_attention_bwd_dkdv, a block per (BT keys, b*KV + kv): its K and V tiles
//      stay in shared memory; it walks the G query heads of kv and, for
//      each, the query tiles that can see its keys (causal: from the tile
//      holding row k0), recomputing P and dS tile by tile, and accumulates
//      dK and dV in registers (4 rows x 8 columns of each a thread).
//   3. flash_attention_bwd_dq, a block per (BT query rows, b*H + h): walks the K/V
//      tiles its rows can see and accumulates dQ in registers.
// Tiles are BT x BT with BT = 64, 32, 16 for d up to 64, 128, 256, so each
// thread holds 32 accumulators of each output at every width; rows are
// staged in shared memory with a stride of d + 1 so that a warp reads
// distinct banks.  Ragged S and T are handled by bounds (rows and columns
// past them zero-filled, masked and never written).
//
// Takes float32 only, d a multiple of 8 up to 256, H a multiple of KV,
// contiguous [B, S, H, d] and [B, T, KV, d] tensors; anything else returns
// cudaErrorInvalidValue before a launch.
//
// Bound on the H100: the gradient needs 10*d operations a live (row,
// column) pair: Q.K^T and dO.V^T again (2d each) and dV, dK, dQ (2d each);
// this kernel does 16*d (S three times, dP twice).  At the qwen2.5-32b train
// cell's (1, 4096, 4096, 40, 8, 128) causal: 3.36e8 live pairs, 4.30e11
// operations, 6.4 ms at 67 TFLOP/s of float32; its bytes (Q, K, V, O, dO in,
// dQ, dK, dV out: 0.29 GB) take 0.09 ms, so it is bound by arithmetic.  This
// first version runs its products as scalar FMAs from shared memory, far
// from that bound; the tensor cores (3xTF32, as B4's "wgmma_f32") are later
// work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// Rows r0 .. r0+BT-1 of a row-major [rows, row_stride] float32 view into
// shared memory with row stride ld; rows at or past n_valid are zero-filled.
template <int BT>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long row_stride,
                                          int r0, int n_valid, int d) {
  const int chunks = d / 4;
  for (int i = threadIdx.x; i < BT * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_valid) v = *reinterpret_cast<const float4*>(src + static_cast<long long>(r0 + r) * row_stride + c);
    float* o = dst + r * ld + c;
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
}

// acc[r][c] = A[rg + 16r] . Bm[cg + 8c] over d, for the thread's 16 x 8
// interleaved share of a BT x BT tile (rg = tid / 8, cg = tid % 8).
template <int BT>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int ld, int d,
                                         float (&acc)[BT / 16][BT / 8]) {
  constexpr int TR = BT / 16, TC = BT / 8;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int e = 0; e < d; ++e) {
    float a[TR], bv[TC];
#pragma unroll
    for (int r = 0; r < TR; ++r) a[r] = A[(rg + 16 * r) * ld + e];
#pragma unroll
    for (int c = 0; c < TC; ++c) bv[c] = Bm[(cg + 8 * c) * ld + e];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ bool live(int row, int col, int S, int Tk, int causal) {
  return row < S && col < Tk && (!causal || row >= col);
}

// P and dS of the staged tiles (rows q0.., columns k0..) into sP and sdS,
// [BT][BT + 1] each: P from Q.K^T and the rows' lse, dS from dO.V^T and D.
template <int BT>
__device__ __forceinline__ void p_ds_tile(const float* sQ, const float* sK, const float* sdO, const float* sV,
                                          const float* sL, const float* sD, float* sP, float* sdS, int ld,
                                          int d, int q0, int k0, int S, int Tk, int causal, float scale) {
  constexpr int TR = BT / 16, TC = BT / 8;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  float acc[TR][TC];
  dot_tile<BT>(sQ, sK, ld, d, acc);
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int rl = rg + 16 * r;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int cl = cg + 8 * c;
      sP[rl * (BT + 1) + cl] = live(q0 + rl, k0 + cl, S, Tk, causal) ? expf(acc[r][c] * scale - sL[rl]) : 0.f;
    }
  }
  dot_tile<BT>(sdO, sV, ld, d, acc);
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int rl = rg + 16 * r;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int cl = cg + 8 * c;
      const float p = sP[rl * (BT + 1) + cl];      // this thread's own entry
      sdS[rl * (BT + 1) + cl] = p * (acc[r][c] - sD[rl]);
    }
  }
}

// Shared memory of kernels 2 and 3: four [BT][d + 1] row tiles, sP and sdS
// [BT][BT + 1], lse and D [BT].
template <int BT>
size_t smem_main(int d) {
  return sizeof(float) * (4 * static_cast<size_t>(BT) * (d + 1) + 2 * BT * (BT + 1) + 2 * BT);
}

template <int BT>
size_t smem_prep(int d) {
  return sizeof(float) * (2 * static_cast<size_t>(BT) * (d + 1) + BT * (BT + 1));
}

template <int BT>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_prep(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ o,
                const float* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
                int S, int Tk, int H, int KV, int d, int causal, float scale) {
  constexpr int TR = BT / 16, TC = BT / 8;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* sQ = smem;                 // [BT][d + 1]
  float* sK = sQ + BT * ld;         // [BT][d + 1]
  float* sS = sK + BT * ld;         // [BT][BT + 1]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const long long q_rs = static_cast<long long>(H) * d, k_rs = static_cast<long long>(KV) * d;
  const float* qb = q + static_cast<long long>(b) * S * q_rs + static_cast<long long>(h) * d;
  const float* kb = k + static_cast<long long>(b) * Tk * k_rs + static_cast<long long>(kvh) * d;
  const long long stat0 = (static_cast<long long>(b) * H + h) * S;

  // D: a warp a row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BT; r += kThreads / 32) {
    const int row = q0 + r;
    if (row >= S) break;
    const long long off = static_cast<long long>(b) * S * q_rs + row * q_rs + static_cast<long long>(h) * d;
    float sum = 0.f;
    for (int c = lane; c < d; c += 32) sum = fmaf(dout[off + c], o[off + c], sum);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (lane == 0) delta[stat0 + row] = sum;
  }

  load_rows<BT>(sQ, ld, qb, q_rs, q0, S, d);
  float m_row = kNegInf, l_row = 0.f;   // row tid's running max and sum (tid < BT)
  int n_tiles = (Tk + BT - 1) / BT;
  if (causal) n_tiles = min(n_tiles, (q0 + BT - 1) / BT + 1);
  const int rg = tid / 8, cg = tid % 8;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                    // the previous tile's readers are done
    load_rows<BT>(sK, ld, kb, k_rs, k0, Tk, d);
    __syncthreads();
    float acc[TR][TC];
    dot_tile<BT>(sQ, sK, ld, d, acc);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int rl = rg + 16 * r;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int cl = cg + 8 * c, row = q0 + rl, col = k0 + cl;
        float s;
        if (col >= Tk) s = __int_as_float(0xff800000);     // -inf: no such key
        else if (causal && row < col) s = kNegInf;          // the forward's mask
        else s = acc[r][c] * scale;
        sS[rl * (BT + 1) + cl] = s;
      }
    }
    __syncthreads();
    if (tid < BT) {                     // column 0 is live for every row, so m is finite after tile 0
      const float* srow = sS + tid * (BT + 1);
      float mx = kNegInf;
      for (int j = 0; j < BT; ++j) mx = fmaxf(mx, srow[j]);
      const float m_new = fmaxf(m_row, mx);
      float sum = 0.f;
      for (int j = 0; j < BT; ++j) sum += expf(srow[j] - m_new);
      l_row = l_row * expf(m_row - m_new) + sum;
      m_row = m_new;
    }
  }
  if (tid < BT && q0 + tid < S) lse[stat0 + q0 + tid] = m_row + logf(l_row);
}

template <int BT, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                int S, int Tk, int H, int KV, int d, int causal, float scale) {
  constexpr int RG = BT / 4, CG = kThreads / RG, OC = DMAX / CG;
  static_assert(RG * CG == kThreads && OC == 8, "accumulator tiling");
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* sK = smem;                 // [BT][d + 1], this block's keys
  float* sV = sK + BT * ld;
  float* sQ = sV + BT * ld;         // a query tile of one head
  float* sdO = sQ + BT * ld;
  float* sP = sdO + BT * ld;        // [BT][BT + 1]
  float* sdS = sP + BT * (BT + 1);
  float* sL = sdS + BT * (BT + 1);  // [BT]
  float* sD = sL + BT;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int G = H / KV;
  const long long q_rs = static_cast<long long>(H) * d, k_rs = static_cast<long long>(KV) * d;
  const long long kv_off = static_cast<long long>(b) * Tk * k_rs + static_cast<long long>(kvh) * d;
  load_rows<BT>(sK, ld, k + kv_off, k_rs, k0, Tk, d);
  load_rows<BT>(sV, ld, v + kv_off, k_rs, k0, Tk, d);

  const int jr = (tid / CG) * 4, cc = tid % CG;   // rows jr..jr+3 (keys), columns cc + CG*x
  float acc_k[4][OC], acc_v[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int x = 0; x < OC; ++x) acc_k[r][x] = acc_v[r][x] = 0.f;

  const int nq = (S + BT - 1) / BT;
  const int qt0 = causal ? k0 / BT : 0;            // causal: rows before k0 see none of these keys
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long q_off = static_cast<long long>(b) * S * q_rs + static_cast<long long>(h) * d;
    const long long stat0 = (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();                  // the previous tile's readers are done
      load_rows<BT>(sQ, ld, q + q_off, q_rs, q0, S, d);
      load_rows<BT>(sdO, ld, dout + q_off, q_rs, q0, S, d);
      if (tid < BT) {
        const bool ok = q0 + tid < S;
        sL[tid] = ok ? lse[stat0 + q0 + tid] : 0.f;
        sD[tid] = ok ? delta[stat0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      p_ds_tile<BT>(sQ, sK, sdO, sV, sL, sD, sP, sdS, ld, d, q0, k0, S, Tk, causal, scale);
      __syncthreads();
      for (int i = 0; i < BT; ++i) {
        float p[4], ds[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p[r] = sP[i * (BT + 1) + jr + r];
          ds[r] = sdS[i * (BT + 1) + jr + r];
        }
#pragma unroll
        for (int x = 0; x < OC; ++x) {
          const int c = cc + CG * x;
          const float dov = c < d ? sdO[i * ld + c] : 0.f;
          const float qv = c < d ? sQ[i * ld + c] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc_v[r][x] = fmaf(p[r], dov, acc_v[r][x]);
            acc_k[r][x] = fmaf(ds[r], qv, acc_k[r][x]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + jr + r;
    if (row >= Tk) continue;
    const long long off = kv_off + row * k_rs;
#pragma unroll
    for (int x = 0; x < OC; ++x) {
      const int c = cc + CG * x;
      if (c < d) {
        dk[off + c] = acc_k[r][x] * scale;
        dv[off + c] = acc_v[r][x];
      }
    }
  }
}

template <int BT, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq,
              int S, int Tk, int H, int KV, int d, int causal, float scale) {
  constexpr int RG = BT / 4, CG = kThreads / RG, OC = DMAX / CG;
  static_assert(RG * CG == kThreads && OC == 8, "accumulator tiling");
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* sQ = smem;                 // [BT][d + 1], this block's rows
  float* sdO = sQ + BT * ld;
  float* sK = sdO + BT * ld;        // a K/V tile
  float* sV = sK + BT * ld;
  float* sP = sV + BT * ld;         // [BT][BT + 1]
  float* sdS = sP + BT * (BT + 1);
  float* sL = sdS + BT * (BT + 1);  // [BT]
  float* sD = sL + BT;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const long long q_rs = static_cast<long long>(H) * d, k_rs = static_cast<long long>(KV) * d;
  const long long q_off = static_cast<long long>(b) * S * q_rs + static_cast<long long>(h) * d;
  const long long kv_off = static_cast<long long>(b) * Tk * k_rs + static_cast<long long>(kvh) * d;
  const long long stat0 = (static_cast<long long>(b) * H + h) * S;
  load_rows<BT>(sQ, ld, q + q_off, q_rs, q0, S, d);
  load_rows<BT>(sdO, ld, dout + q_off, q_rs, q0, S, d);
  if (tid < BT) {
    const bool ok = q0 + tid < S;
    sL[tid] = ok ? lse[stat0 + q0 + tid] : 0.f;
    sD[tid] = ok ? delta[stat0 + q0 + tid] : 0.f;
  }

  const int ir = (tid / CG) * 4, cc = tid % CG;   // rows ir..ir+3, columns cc + CG*x
  float acc[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int x = 0; x < OC; ++x) acc[r][x] = 0.f;

  int n_tiles = (Tk + BT - 1) / BT;
  if (causal) n_tiles = min(n_tiles, (q0 + BT - 1) / BT + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                    // the previous tile's readers are done
    load_rows<BT>(sK, ld, k + kv_off, k_rs, k0, Tk, d);
    load_rows<BT>(sV, ld, v + kv_off, k_rs, k0, Tk, d);
    __syncthreads();
    p_ds_tile<BT>(sQ, sK, sdO, sV, sL, sD, sP, sdS, ld, d, q0, k0, S, Tk, causal, scale);
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = sdS[(ir + r) * (BT + 1) + j];
#pragma unroll
      for (int x = 0; x < OC; ++x) {
        const int c = cc + CG * x;
        const float kv = c < d ? sK[j * ld + c] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][x] = fmaf(ds[r], kv, acc[r][x]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ir + r;
    if (row >= S) continue;
    const long long off = q_off + row * q_rs;
#pragma unroll
    for (int x = 0; x < OC; ++x) {
      const int c = cc + CG * x;
      if (c < d) dq[off + c] = acc[r][x] * scale;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <int BT, int DMAX>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
                   float* dq, float* dk, float* dv, float* lse, float* delta, int B, int S, int Tk, int H,
                   int KV, int d, int causal, float scale, cudaStream_t stream) {
  const size_t prep = smem_prep<BT>(d), body = smem_main<BT>(d);
  cudaError_t err;
  if ((err = allow_smem(flash_attention_bwd_prep<BT>, prep)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_attention_bwd_dkdv<BT, DMAX>, body)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_attention_bwd_dq<BT, DMAX>, body)) != cudaSuccess) return err;
  const dim3 q_grid((S + BT - 1) / BT, B * H), k_grid((Tk + BT - 1) / BT, B * KV);
  flash_attention_bwd_prep<BT><<<q_grid, kThreads, prep, stream>>>(q, k, o, dout, lse, delta, S, Tk, H, KV, d,
                                                         causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_attention_bwd_dkdv<BT, DMAX><<<k_grid, kThreads, body, stream>>>(q, k, v, dout, lse, delta, dk, dv, S, Tk,
                                                                H, KV, d, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_attention_bwd_dq<BT, DMAX><<<q_grid, kThreads, body, stream>>>(q, k, v, dout, lse, delta, dq, S, Tk, H,
                                                              KV, d, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
                                   int B, int S, int Tk, int H, int KV, int d, int causal, float scale,
                                   void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || KV <= 0 || H % KV != 0 || B <= 0 || S <= 0 || Tk <= 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* in[5] = {static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(o),
                        static_cast<const float*>(dout)};
  float* out[5] = {static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                   static_cast<float*>(lse), static_cast<float*>(delta)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 64)
    err = launch<64, 64>(in[0], in[1], in[2], in[3], in[4], out[0], out[1], out[2], out[3], out[4], B, S, Tk,
                         H, KV, d, causal, scale, s);
  else if (d <= 128)
    err = launch<32, 128>(in[0], in[1], in[2], in[3], in[4], out[0], out[1], out[2], out[3], out[4], B, S,
                          Tk, H, KV, d, causal, scale, s);
  else
    err = launch<16, 256>(in[0], in[1], in[2], in[3], in[4], out[0], out[1], out[2], out[3], out[4], B, S,
                          Tk, H, KV, d, causal, scale, s);
  return static_cast<int>(err);
}
