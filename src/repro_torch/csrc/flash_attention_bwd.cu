// The backward of causal or full GQA attention: (dQ, dK, dV) from Q, K, V,
// the forward's output O and row statistics lse2, and the output's
// gradient dO, float32.
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
//     P[i,j]  = 2^(s[i,j]*scale*log2(e) - lse2[i]),  s = Q.K^T
//     D[i]    = sum_c dO[i,c] O[i,c]          (= sum_j P[i,j] dP[i,j])
//     dP[i,j] = dO[i] . V[j],   dS[i,j] = P[i,j] (dP[i,j] - D[i])
//     dQ[i]   = scale * sum_j dS[i,j] K[j]
//     dK[j]   = scale * sum_{h of kv} sum_i dS[i,j] Q[i],   dV[j] = sum_{h of kv} sum_i P[i,j] dO[i]
// lse2 is what B4's "wgmma_f32" body writes beside its output when asked
// (flash_attention.cu): each row's log-sum-exp in base 2, m + log2(l), with
// m the row's largest s*scale*log2(e) and l its sum of 2^(s*scale*log2(e) -
// m); so P is rebuilt by one FMA and one ex2, as the forward forms it, and no
// launch recomputes the rows' statistics.  A masked pair has P = 0 exactly.
//
// Three launches on the caller's stream, no atomics, so the result is the
// same bits every run:
//   1. flash_attention_bwd_delta: D of each row, a warp a row (coalesced),
//      into [B, H, S] float32 scratch; bound by its bytes.
//   2. the dK/dV kernel, a block per (b*KV + kv, BK keys): its K and V tiles
//      stay in shared memory; it walks the G query heads of kv and, for
//      each, the query tiles that can see its keys (causal: from the tile
//      holding row k0), recomputing P and dS tile by tile, and accumulates
//      dK and dV in registers.  Blocks of the first keys (causal: the most
//      query tiles) are scheduled first.
//   3. the dQ kernel, a block per (b*H + h, query rows): walks the K/V tiles
//      its rows can see and accumulates dQ in registers, the last query
//      tiles (causal: the most keys) first.
// 10*d operations a live (row, column) pair are needed: Q.K^T and dO.V^T
// again (2d each) and dV, dK, dQ (2d each).  Both bodies issue 14*d: S and
// dP are formed once in each of kernels 2 and 3.
//
// "wgmma_f32" (d a multiple of 8 up to 128): the products on the tensor
// cores as 3xTF32 (tf32_wgmma.cuh): a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi,
// the forward's arithmetic (emulated on the CPU against the card check's
// gate of 1e-4 max |ref| in tests/test_torch_attention_bwd.py: three TF32
// products on every product hold it, one breaks it).  One instantiation a
// width bucket D = 32, 64, 96, 128, columns d..D-1 zero in shared memory.
// TF32 has no transpose bit, so every operand that is contracted over rows
// or keys is staged transposed, and an operand that a product takes from
// the accumulators of another is staged with its rows permuted within each
// 8-slice (row r at position (r%2)*4 + (r%8)/2), the forward's V^T trick:
// the accumulator's (2t, 2t+1) then are the A fragment's (t, t+4).
//   dK/dV block: BK = 64 keys (wgmma's M), query tiles of BQ = 32 rows,
//     one or two warpgroups (below).  K and V stay raw in shared memory,
//     the A operands of S^T = K.Q^T and dP^T = V.dO^T (m64n32k8): a warp
//     loads its fragment with one ldmatrix a k-step ahead and splits it
//     into hi and lo in registers.  Q and dO land raw and are split once into hi/lo as
//     stored (the B operands of S^T, dP^T) and transposed (Q^T, dO^T: the
//     B operands of dK += dS^T.Q and dV += P^T.dO, with P^T and dS^T from
//     the accumulators as A, from registers).  Up to D = 64 one warpgroup
//     holds all of dK and dV (m64n{D}k8), two blocks an SM: two warpgroups
//     trading S^T and dP^T as below took whisper's encoder row 6.7 ms on
//     an H100, one 5.5.
//     At D = 96 and 128 two warpgroups each own half of dK's and dV's
//     columns (m64n{D/2}k8): dK and dV for 64 keys at D = 128 take 128
//     accumulators a thread in one warpgroup, which left no room for the
//     tile sums below (255 registers, spilling).  Warpgroup 0 forms S^T
//     and warpgroup 1 dP^T, and they trade them through shared memory (16
//     KB), so the block issues 8*d a live pair, as one warpgroup does (on
//     an H100 the train cell's backward took 14.2 ms so, 15.6 with both
//     warpgroups forming both).  Shared memory: 2*64*D + 8*32*D floats,
//     192 KB at D = 128 and the trade's 16 (one block an SM), 96 KB at 64
//     (two).
//   dQ block: two warpgroups, 128 query rows (64 each), K/V tiles of 32
//     keys shared by both.  Q and dO stay raw (ldmatrix + split in
//     registers, as above: the A operands of S = Q.K^T and dP = dO.V^T,
//     m64n32k8); K lands raw and is split into hi/lo as stored (the B of
//     S) and transposed (K^T, the B of dQ += dS.K, m64n{D}k8); V is split
//     in place.  2*128*D + 6*32*D floats, 224 KB at D = 128.
//   Each tile's dV, dK or dQ is summed from zero in registers of its own
//   and then added to the running sum in float32 to nearest: the tensor
//   cores' float32 sums drop bits toward zero, and a running sum that took
//   every wgmma of a long walk drifted (dK and dV of the train cell's first
//   keys, ~7,700 wgmmas a key, read 1.45e-4 of max |ref| low on the card).
//   Copies are cp.async into the INTERLEAVE layout; the next tile's raw
//   copy is issued as soon as the products that read its slot are done, so
//   it overlaps P, dS and the accumulating products.  The splits are not
//   overlapped with the tensor cores.  Not yet here: TMA, a producer warp,
//   the swizzle, double-buffered slots.
// Bound on the H100 at the qwen2.5-32b train cell's (1, 4096, 4096, 40, 8,
// 128) causal: 3.36e8 live pairs, 4.30e11 float32 operations needed, as
// 3xTF32 1.29e12 TF32 operations, 2.6 ms at 495 TFLOP/s (6.4 ms as float32
// FMAs at 67); this body issues 3*14*d a pair (1.81e12 on live pairs, more
// on the diagonal tiles' masked ones); its bytes (Q, K, V, O, dO in, dQ, dK,
// dV out: 0.29 GB) take 0.09 ms.
//
// "simt" (d above 128, gemma's 256): float32 FMAs on the CUDA cores, 128
// threads, BT = 16 query rows and keys a tile; rows are staged in shared
// memory with a stride of d + 1 so that a warp reads distinct banks; each
// thread holds 4 rows x 8 columns of each output.  The tensor-core dK/dV
// block does not fit there: K and V raw for 64 keys take 128 KB of shared
// memory, Q, dO and their split transposes for a query tile of 32 another
// 256 KB, and dK and dV 256 accumulators a thread in one warpgroup; it
// needs another split of the work (ROADMAP §B 1e).
//
// Takes float32 only, d a multiple of 8 up to 256, H a multiple of KV,
// contiguous [B, S, H, d] and [B, T, KV, d] tensors and a contiguous
// [B, H, S] lse2; anything else returns cudaErrorInvalidValue before a
// launch.  Ragged S and T are handled by bounds (rows and columns past them
// zero-filled, masked and never written).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// D[b, h, s] = sum_c dO[b, s, h, c] O[b, s, h, c]: a warp a row, row =
// (b*S + s)*H + h of the contiguous [B, S, H, d] tensors.
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                          float* __restrict__ delta, int S, int H, int d, long long rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp;
  if (row >= rows) return;
  const float* dr = dout + row * d;
  const float* orow = o + row * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum = fmaf(dr[c], orow[c], sum);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) {
    const long long bs = row / H;
    const long long b = bs / S;
    delta[(b * H + row % H) * S + bs % S] = sum;
  }
}

// ------------------------------------------------------------------ "simt" body
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
// [BT][BT + 1] each: P from Q.K^T and the rows' lse2 (base 2), dS from
// dO.V^T and D.
template <int BT>
__device__ __forceinline__ void p_ds_tile(const float* sQ, const float* sK, const float* sdO, const float* sV,
                                          const float* sL, const float* sD, float* sP, float* sdS, int ld,
                                          int d, int q0, int k0, int S, int Tk, int causal, float scale_log2) {
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
      sP[rl * (BT + 1) + cl] = live(q0 + rl, k0 + cl, S, Tk, causal) ? exp2f(acc[r][c] * scale_log2 - sL[rl]) : 0.f;
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

// Shared memory of the two kernels: four [BT][d + 1] row tiles, sP and sdS
// [BT][BT + 1], lse2 and D [BT].
template <int BT>
size_t smem_main(int d) {
  return sizeof(float) * (4 * static_cast<size_t>(BT) * (d + 1) + 2 * BT * (BT + 1) + 2 * BT);
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
      p_ds_tile<BT>(sQ, sK, sdO, sV, sL, sD, sP, sdS, ld, d, q0, k0, S, Tk, causal, scale * kLog2e);
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
    p_ds_tile<BT>(sQ, sK, sdO, sV, sL, sD, sP, sdS, ld, d, q0, k0, S, Tk, causal, scale * kLog2e);
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


// ------------------------------------------------------------- "wgmma_f32" body
namespace tc {

using tfw::cp_async_commit;
using tfw::cp_async_wait_all;
using tfw::ex2;
using tfw::fence_proxy_async;
using tfw::fence_regs;
using tfw::ldmatrix_x4;
using tfw::load_tile;
using tfw::make_desc;
using tfw::mma_rs;
using tfw::smem_addr;
using tfw::split;
using tfw::tf32;
using tfw::wgmma_commit;
using tfw::wgmma_fence;
using tfw::wgmma_wait;

constexpr int kKeys = 64;        // keys of a dK/dV block: wgmma's M
constexpr int kQTile = 32;       // query rows of a dK/dV block's tile: S^T's N
constexpr int kQRows = 128;      // query rows of a dQ block: two warpgroups of 64
constexpr int kKTile = 32;       // keys of a dQ block's K/V tile: S's N

// In place: each raw float32 x of a [ROWS][D] INTERLEAVE tile (D/4 chunks
// a row) in lo becomes tf32(x) in hi and tf32(x - tf32(x)) in lo, and the
// same two values go to th and tl transposed: a [D][ROWS] tile whose row n
// holds column n, ROWS/4 chunks a row, each 8-row slice permuted (row r at
// position (r%2)*4 + (r%8)/2; see the note).
template <int THREADS, int ROWS, int D>
__device__ __forceinline__ void split_t(unsigned char* hi, unsigned char* lo, unsigned char* th,
                                        unsigned char* tl) {
  constexpr int C = D / 4, kBytes = ROWS * D * 4;
#pragma unroll 2
  for (int i = threadIdx.x * 16; i < kBytes; i += THREADS * 16) {
    const float4 x = *reinterpret_cast<const float4*>(lo + i);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = tf32(xs[e]);
      l[e] = tf32(xs[e] - h[e]);
    }
    *reinterpret_cast<float4*>(hi + i) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + i) = make_float4(l[0], l[1], l[2], l[3]);
    const int cm = i >> 7, r = (cm / C) * 8 + ((i & 127) >> 4), c = cm % C;
    const int rpart = (2 * (r >> 3) + (r & 1)) * 128 + ((r & 7) >> 1) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * c + e;
      const int off = (n >> 3) * (ROWS / 4) * 128 + (n & 7) * 16 + rpart;
      *reinterpret_cast<float*>(th + off) = h[e];
      *reinterpret_cast<float*>(tl + off) = l[e];
    }
  }
}

// A raw A fragment (ldmatrix) into its TF32 halves.
__device__ __forceinline__ void split_frag(const uint32_t (&raw)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x = __uint_as_float(raw[r]), xh = tf32(x);
    hi[r] = __float_as_uint(xh);
    lo[r] = __float_as_uint(tf32(x - xh));
  }
}

// The accumulator a (m64n{8*NJ}) as the A fragments of NJ k-slices, split:
// positions t and t + 4 of slice j hold a's columns 8j + 2t and 8j + 2t + 1
// (the B operand's permuted rows), this thread's a[4j], a[4j + 2], a[4j + 1],
// a[4j + 3].
template <int NJ>
__device__ __forceinline__ void acc_frags(const float (&a)[4 * NJ], uint32_t (&hi)[NJ][4],
                                          uint32_t (&lo)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float v[4] = {a[4 * j], a[4 * j + 2], a[4 * j + 1], a[4 * j + 3]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float h = tf32(v[r]);
      hi[j][r] = __float_as_uint(h);
      lo[j][r] = __float_as_uint(tf32(v[r] - h));
    }
  }
}

// x = A.B over D/8 k-steps: A raw in shared memory (ldmatrix at a_frag, a
// k-step ahead, split in registers), B as hi/lo descriptors; 3 TF32
// products a k-step, the first overwriting x, two k-steps in flight.
// Waits for all of them.
template <int D, int N>
__device__ __forceinline__ void frag_product(float (&x)[N], uint32_t a_frag, uint64_t bh, uint64_t bl) {
  fence_regs(x);
  uint32_t raw[4];
  ldmatrix_x4(raw, a_frag);
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ah[4], al[4];
    split_frag(raw, ah, al);
    if (ks + 1 < D / 8) ldmatrix_x4(raw, a_frag + 256 * (ks + 1));
    wgmma_fence();
    mma_rs(x, ah, bh + 16 * ks, ks > 0);
    mma_rs(x, ah, bl + 16 * ks);
    mma_rs(x, al, bh + 16 * ks);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(x);
}

// The descriptor of a no-swizzle operand at byte offset off of the block's
// shared memory (base), chunks 128 B apart in K and 8-row groups sbo apart.
__device__ __forceinline__ uint64_t desc_at(uint32_t base, uint32_t off, uint32_t sbo) {
  return make_desc(base + off, 128, sbo);
}

// acc += A.B over NJ k-slices of 8, A from the accumulator a (acc_frags), B
// as hi/lo descriptors of a transposed, permuted tile.  The tile's sum is
// formed in tmp from zero and then added to acc to nearest: the tensor
// cores' float32 sums drop bits toward zero, so an accumulator that took
// every wgmma of a long walk drifted (dK and dV of the train cell's first
// keys, ~7,700 wgmmas a key, read 1.45e-4 of max |ref| low on the card).
template <int NJ, int NACC>
__device__ __forceinline__ void tile_product(float (&acc)[NACC], float (&tmp)[NACC], const float (&a)[4 * NJ],
                                             uint64_t bh, uint64_t bl) {
  uint32_t ah[NJ][4], al[NJ][4];
  acc_frags<NJ>(a, ah, al);
  fence_regs(tmp);
  fence_regs(ah);
  fence_regs(al);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mma_rs(tmp, ah[j], bh + 16 * j, j > 0);
    mma_rs(tmp, ah[j], bl + 16 * j);
    mma_rs(tmp, al[j], bh + 16 * j);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(tmp);
  fence_regs(ah);
  fence_regs(al);
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] += tmp[i];
}

// acc (m64n{2*NACC}) times scale into this thread's two output rows, row
// and row + 8 of out (row stride ld; none at or past n_rows), columns below
// d.
template <int NACC>
__device__ __forceinline__ void store_rows(const float (&acc)[NACC], float* out, int row, int n_rows, long long ld,
                                           float scale, int d, int t2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n_rows) continue;
    float* orow = out + (row + 8 * r) * ld + t2;
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
      if (8 * j < d)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// The dK/dV block's warpgroups at width bucket D (see the note).
template <int D>
__host__ __device__ constexpr int kvGroups() {
  return D > 64 ? 2 : 1;
}

// K and V raw, Q, dO and their transposes split, the tile's lse2 and D,
// and with two warpgroups the S^T and dP^T they hand each other.
template <int D>
constexpr size_t dkdv_smem() {
  return static_cast<size_t>(2 * kKeys * D + 8 * kQTile * D + 2 * kQTile +
                             (kvGroups<D>() == 2 ? 2 * kKeys * kQTile : 0)) * 4;
}
template <int D>
constexpr size_t dq_smem() {
  return static_cast<size_t>(2 * kQRows * D + 6 * kKTile * D) * 4;
}

template <int D>
__global__ void __launch_bounds__(kvGroups<D>() * kThreads)
flash_attention_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv, int S, int Tk, int H, int KV,
                              int d, int causal, float scale, float scale_log2) {
  constexpr int kThr = kvGroups<D>() * kThreads, C = D / 4;
  constexpr int DH = D / kvGroups<D>();       // a warpgroup's columns of dK and dV
  constexpr int kKVBytes = kKeys * D * 4, kQBytes = kQTile * D * 4;
  extern __shared__ __align__(128) unsigned char tiles[];
  unsigned char* sK = tiles;                  // raw: the A of S^T
  unsigned char* sV = sK + kKVBytes;          // raw: the A of dP^T
  unsigned char* sQh = sV + kKVBytes;         // Q's tile: the B of S^T
  unsigned char* sQl = sQh + kQBytes;         // (its raw copy lands here)
  unsigned char* sOh = sQl + kQBytes;         // dO's tile: the B of dP^T
  unsigned char* sOl = sOh + kQBytes;
  unsigned char* sQTh = sOl + kQBytes;        // Q^T: the B of dK
  unsigned char* sQTl = sQTh + kQBytes;
  unsigned char* sOTh = sQTl + kQBytes;       // dO^T: the B of dV
  unsigned char* sOTl = sOTh + kQBytes;
  float* sL = reinterpret_cast<float*>(sOTl + kQBytes);   // the tile's rows' lse2 and D
  float* sD = sL + kQTile;
  float* sX = sD + kQTile;                    // two warpgroups: [2][kQTile/8][128 threads][4]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = warp / 4;                 // this thread's warpgroup: columns DH*group ..
  const int k0 = blockIdx.y * kKeys;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const long long q_rs = static_cast<long long>(H) * d, k_rs = static_cast<long long>(KV) * d;
  const long long kv_off = static_cast<long long>(b) * Tk * k_rs + static_cast<long long>(kvh) * d;
  const int nq = (S + kQTile - 1) / kQTile;
  const int qt0 = causal ? min(k0 / kQTile, nq) : 0;    // causal: rows before k0 see none of these keys
  const int nqt = nq - qt0, n_iter = G * nqt;

  auto stage = [&](int it) {                  // the raw Q and dO tiles of iteration it
    const int h = kvh * G + it / nqt, q0 = (qt0 + it % nqt) * kQTile;
    const long long q_off = static_cast<long long>(b) * S * q_rs + static_cast<long long>(h) * d;
    load_tile<kThr, kQTile, C, C>(sQl, q + q_off, q_rs, q0, S, d / 4);
    load_tile<kThr, kQTile, C, C>(sOl, dout + q_off, q_rs, q0, S, d / 4);
  };
  load_tile<kThr, kKeys, C, C>(sK, k + kv_off, k_rs, k0, Tk, d / 4);
  load_tile<kThr, kKeys, C, C>(sV, v + kv_off, k_rs, k0, Tk, d / 4);
  if (n_iter > 0) stage(0);
  cp_async_commit();

  // Q, dO: chunks c and c+1 (K) 128 B apart, 8-row groups C*128 B apart.
  // Q^T, dO^T: chunks of 4 rows 128 B apart, 8-column groups (kQTile/4)*128
  // B apart; a warpgroup's DH columns start DH/8 groups in.  Both
  // warpgroups form S^T and dP^T of all 64 keys: a warp's ldmatrix reads
  // the core matrix of its row group 2*(warp%4) + (lane/8)%2 and chunk
  // lane/16 of the k-step (tf32's A fragment).
  constexpr uint32_t kSbo = C * 128, kTSbo = (kQTile / 4) * 128;
  constexpr uint32_t kQh = 2 * kKVBytes, kQl = kQh + kQBytes, kOh = kQl + kQBytes, kOl = kOh + kQBytes;
  constexpr uint32_t kQTh = kOl + kQBytes, kQTl = kQTh + kQBytes, kOTh = kQTl + kQBytes, kOTl = kOTh + kQBytes;
  const uint32_t base = smem_addr(tiles), cols = group * (DH / 8) * kTSbo;
  const uint32_t a_off = ((2 * (warp % 4) + (lane / 8) % 2) * C + lane / 16) * 128 + (lane % 8) * 16;
  const uint32_t k_frag = base + a_off, v_frag = base + kKVBytes + a_off;

  float acc_k[DH / 2], acc_v[DH / 2], tmp[DH / 2], s[kQTile / 2], dp[kQTile / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = tmp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kQTile / 2; ++i) s[i] = dp[i] = 0.f;
  const int key0 = k0 + 16 * (warp % 4) + lane / 4;     // this thread's keys: key0, key0 + 8
  const int t2 = 2 * (lane % 4);                        // and query rows q0 + 8j + t2, + 1

  for (int it = 0; it < n_iter; ++it) {
    const int h = kvh * G + it / nqt, q0 = (qt0 + it % nqt) * kQTile;
    const long long stat0 = (static_cast<long long>(b) * H + h) * S;
    cp_async_wait_all();
    __syncthreads();                          // the tile has landed; the last tile's products are done
    split_t<kThr, kQTile, D>(sQh, sQl, sQTh, sQTl);
    split_t<kThr, kQTile, D>(sOh, sOl, sOTh, sOTl);
    if (tid < kQTile) {
      const bool ok = q0 + tid < S;
      sL[tid] = ok ? lse[stat0 + q0 + tid] : 0.f;
      sD[tid] = ok ? delta[stat0 + q0 + tid] : 0.f;
    }
    fence_proxy_async();
    __syncthreads();

    if constexpr (kvGroups<D>() == 1) {
      frag_product<D>(s, k_frag, desc_at(base, kQh, kSbo), desc_at(base, kQl, kSbo));     // S^T = K.Q^T
      frag_product<D>(dp, v_frag, desc_at(base, kOh, kSbo), desc_at(base, kOl, kSbo));    // dP^T = V.dO^T
      __syncthreads();                        // every thread's: Q's and dO's slots are free
    } else {
      // warpgroup 0 forms S^T = K.Q^T and warpgroup 1 dP^T = V.dO^T (the
      // same code on other operands: no branch for ptxas to serialize the
      // wgmmas behind), and each hands the other its accumulator through
      // shared memory, 4 floats a store, a warp's 32 stores contiguous
      frag_product<D>(s, group ? v_frag : k_frag, desc_at(base, group ? kOh : kQh, kSbo),
                      desc_at(base, group ? kOl : kQl, kSbo));
      const int lt = tid % 128;
#pragma unroll
      for (int j = 0; j < kQTile / 8; ++j)
        *reinterpret_cast<float4*>(sX + ((group * (kQTile / 8) + j) * 128 + lt) * 4) =
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      __syncthreads();                        // every thread's: Q's and dO's slots are free, sX full
#pragma unroll
      for (int j = 0; j < kQTile / 8; ++j) {
        const float4 o = *reinterpret_cast<const float4*>(sX + (((1 - group) * (kQTile / 8) + j) * 128 + lt) * 4);
        const float other[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float own = s[4 * j + e];
          s[4 * j + e] = group ? other[e] : own;
          dp[4 * j + e] = group ? own : other[e];
        }
      }
    }
    if (it + 1 < n_iter) {
      stage(it + 1);
      cp_async_commit();
    }

    // P^T and dS^T in place of S^T and dP^T
#pragma unroll
    for (int j = 0; j < kQTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + t2 + (e & 1), row = q0 + cl, key = key0 + 8 * (e >> 1);
        const bool live = row < S && key < Tk && (!causal || row >= key);
        const float p = live ? ex2(fmaf(s[4 * j + e], scale_log2, -sL[cl])) : 0.f;
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - sD[cl]);
      }
    tile_product<kQTile / 8>(acc_v, tmp, s, desc_at(base, kOTh + cols, kTSbo),
                             desc_at(base, kOTl + cols, kTSbo));                          // dV += P^T.dO
    tile_product<kQTile / 8>(acc_k, tmp, dp, desc_at(base, kQTh + cols, kTSbo),
                             desc_at(base, kQTl + cols, kTSbo));                          // dK += dS^T.Q
  }
  const int c0 = group * DH;                  // no query tile: zeros
  store_rows(acc_v, dv + kv_off + c0, key0, Tk, k_rs, 1.f, d - c0, t2);
  store_rows(acc_k, dk + kv_off + c0, key0, Tk, k_rs, scale, d - c0, t2);
}

template <int D>
__global__ void __launch_bounds__(2 * kThreads)
flash_attention_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int S, int Tk, int H, int KV, int d, int causal,
                            float scale, float scale_log2) {
  constexpr int kThr = 2 * kThreads, C = D / 4;
  constexpr int kRowBytes = kQRows * D * 4, kKBytes = kKTile * D * 4;
  extern __shared__ __align__(128) unsigned char tiles[];
  unsigned char* sQ = tiles;                  // raw: the A of S
  unsigned char* sO = sQ + kRowBytes;         // raw dO: the A of dP
  unsigned char* sKh = sO + kRowBytes;        // K's tile: the B of S
  unsigned char* sKl = sKh + kKBytes;         // (its raw copy lands here)
  unsigned char* sVh = sKl + kKBytes;         // V's tile: the B of dP
  unsigned char* sVl = sVh + kKBytes;
  unsigned char* sKTh = sVl + kKBytes;        // K^T: the B of dQ
  unsigned char* sKTl = sKTh + kKBytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = warp / 4;                 // this thread's warpgroup: rows q0 + 64*group ..
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;   // the last rows (causal: the most keys) first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const long long q_rs = static_cast<long long>(H) * d, k_rs = static_cast<long long>(KV) * d;
  const long long q_off = static_cast<long long>(b) * S * q_rs + static_cast<long long>(h) * d;
  const long long kv_off = static_cast<long long>(b) * Tk * k_rs + static_cast<long long>(kvh) * d;
  const long long stat0 = (static_cast<long long>(b) * H + h) * S;
  int n_tiles = (Tk + kKTile - 1) / kKTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kQRows - 1) / kKTile + 1);

  load_tile<kThr, kQRows, C, C>(sQ, q + q_off, q_rs, q0, S, d / 4);
  load_tile<kThr, kQRows, C, C>(sO, dout + q_off, q_rs, q0, S, d / 4);
  load_tile<kThr, kKTile, C, C>(sKl, k + kv_off, k_rs, 0, Tk, d / 4);
  load_tile<kThr, kKTile, C, C>(sVl, v + kv_off, k_rs, 0, Tk, d / 4);
  cp_async_commit();

  const int row0 = q0 + 64 * group + 16 * (warp % 4) + lane / 4;   // this thread's rows: row0, row0 + 8
  const int t2 = 2 * (lane % 4);                                    // and keys k0 + 8j + t2, + 1
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < S;
    lr[r] = ok ? lse[stat0 + row0 + 8 * r] : 0.f;
    dr[r] = ok ? delta[stat0 + row0 + 8 * r] : 0.f;
  }

  constexpr uint32_t kLbo = 128, kSbo = C * 128, kTSbo = (kKTile / 4) * 128;
  const uint64_t dkh = make_desc(smem_addr(sKh), kLbo, kSbo), dkl = make_desc(smem_addr(sKl), kLbo, kSbo);
  const uint64_t dvh = make_desc(smem_addr(sVh), kLbo, kSbo), dvl = make_desc(smem_addr(sVl), kLbo, kSbo);
  const uint64_t dkth = make_desc(smem_addr(sKTh), kLbo, kTSbo), dktl = make_desc(smem_addr(sKTl), kLbo, kTSbo);
  const uint32_t a_off = ((group * 8 + 2 * (warp % 4) + (lane / 8) % 2) * C + lane / 16) * 128 + (lane % 8) * 16;
  const uint32_t q_frag = smem_addr(sQ) + a_off, o_frag = smem_addr(sO) + a_off;

  float acc[D / 2], tmp[D / 2], s[kKTile / 2], dp[kKTile / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = tmp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKTile / 2; ++i) s[i] = dp[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKTile;
    cp_async_wait_all();
    __syncthreads();                          // the tile has landed; the last tile's products are done
    split_t<kThr, kKTile, D>(sKh, sKl, sKTh, sKTl);
    split<kThr, kKBytes, 2>(sVh, sVl);
    fence_proxy_async();
    __syncthreads();

    frag_product<D>(s, q_frag, dkh, dkl);                // S = Q.K^T
    frag_product<D>(dp, o_frag, dvh, dvl);               // dP = dO.V^T
    __syncthreads();                          // both warpgroups': K's and V's slots are free
    if (kt + 1 < n_tiles) {
      load_tile<kThr, kKTile, C, C>(sKl, k + kv_off, k_rs, k0 + kKTile, Tk, d / 4);
      load_tile<kThr, kKTile, C, C>(sVl, v + kv_off, k_rs, k0 + kKTile, Tk, d / 4);
      cp_async_commit();
    }

#pragma unroll
    for (int j = 0; j < kKTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + t2 + (e & 1), row = row0 + 8 * (e >> 1);
        const bool live = row < S && key < Tk && (!causal || row >= key);
        const float p = live ? ex2(fmaf(s[4 * j + e], scale_log2, -lr[e >> 1])) : 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - dr[e >> 1]);
      }
    tile_product<kKTile / 8>(acc, tmp, dp, dkth, dktl);  // dQ += dS.K
  }
  store_rows(acc, dq + q_off, row0, S, q_rs, scale, d, t2);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                   const float* delta, float* dq, float* dk, float* dv, int B, int S, int Tk, int H, int KV,
                   int d, int causal, float scale, cudaStream_t stream) {
  constexpr size_t kv_smem = dkdv_smem<D>(), q_smem = dq_smem<D>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kv_smem))) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(flash_attention_bwd_dq_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(q_smem))) != cudaSuccess)
    return err;
  const dim3 kv_grid(B * KV, (Tk + kKeys - 1) / kKeys), q_grid(B * H, (S + kQRows - 1) / kQRows);
  flash_attention_bwd_dkdv_tf32<D><<<kv_grid, kvGroups<D>() * kThreads, kv_smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, Tk, H, KV, d, causal, scale, scale * kLog2e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_attention_bwd_dq_tf32<D><<<q_grid, 2 * kThreads, q_smem, stream>>>(
      q, k, v, dout, lse, delta, dq, S, Tk, H, KV, d, causal, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

cudaError_t launch_simt(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                        const float* delta, float* dq, float* dk, float* dv, int B, int S, int Tk, int H, int KV,
                        int d, int causal, float scale, cudaStream_t stream) {
  constexpr int BT = 16, DMAX = 256;
  const size_t body = smem_main<BT>(d);
  cudaError_t err;
  if ((err = allow_smem(flash_attention_bwd_dkdv<BT, DMAX>, body)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_attention_bwd_dq<BT, DMAX>, body)) != cudaSuccess) return err;
  const dim3 q_grid((S + BT - 1) / BT, B * H), k_grid((Tk + BT - 1) / BT, B * KV);
  flash_attention_bwd_dkdv<BT, DMAX><<<k_grid, kThreads, body, stream>>>(q, k, v, dout, lse, delta, dk, dv, S, Tk,
                                                                H, KV, d, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_attention_bwd_dq<BT, DMAX><<<q_grid, kThreads, body, stream>>>(q, k, v, dout, lse, delta, dq, S, Tk, H,
                                                              KV, d, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The body follows from d alone: "wgmma_f32" (the tensor cores) up to d = 128
// at the width bucket 32, 64, 96 or 128, "simt" above, as
// kernels/flash_attention/kernel.py's select_bwd_body names them.  lse2 is
// B4's [B, H, S] float32 output (base 2); delta is [B, H, S] float32 scratch.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* dk, void* dv,
                                   void* delta, int B, int S, int Tk, int H, int KV, int d, int causal,
                                   float scale, void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || KV <= 0 || H % KV != 0 || B <= 0 || S <= 0 || Tk <= 0 ||
      B * H > 65535 || (S + 15) / 16 > 65535 || (Tk + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* delf = static_cast<float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * S * H;
  flash_attention_bwd_delta<<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                              s>>>(of, df, delf, S, H, d, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d > 128)
    err = launch_simt(qf, kf, vf, df, lf, delf, dqf, dkf, dvf, B, S, Tk, H, KV, d, causal, scale, s);
  else if (d <= 32)
    err = tc::launch<32>(qf, kf, vf, df, lf, delf, dqf, dkf, dvf, B, S, Tk, H, KV, d, causal, scale, s);
  else if (d <= 64)
    err = tc::launch<64>(qf, kf, vf, df, lf, delf, dqf, dkf, dvf, B, S, Tk, H, KV, d, causal, scale, s);
  else if (d <= 96)
    err = tc::launch<96>(qf, kf, vf, df, lf, delf, dqf, dkf, dvf, B, S, Tk, H, KV, d, causal, scale, s);
  else
    err = tc::launch<128>(qf, kf, vf, df, lf, delf, dqf, dkf, dvf, B, S, Tk, H, KV, d, causal, scale, s);
  return static_cast<int>(err);
}

// The "wgmma_f32" body's tiling at head dim d, for counting what it issues:
// tiles = {width bucket, keys of a dK/dV block, query rows of its tiles,
// query rows of a dQ block, keys of its tiles}.  Returns
// cudaErrorInvalidValue where d is not one that body takes.
extern "C" int flash_attention_bwd_tiles(int d, int* tiles) {
  if (d < 8 || d > 128 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  tiles[0] = d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : 128;
  tiles[1] = tc::kKeys;
  tiles[2] = tc::kQTile;
  tiles[3] = tc::kQRows;
  tiles[4] = tc::kKTile;
  return 0;
}
