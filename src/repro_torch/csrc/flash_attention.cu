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
// query and key lengths differ.  Keys at or past T get weight 0 (-inf).
//
// Three bodies, chosen by the caller from (dtype, d) before the launch and
// passed in as ``body``; the entry point refuses a body that cannot take
// the shape.  All keep the TPU kernel's arithmetic: P is float32 there
// (kernel.py:54, 74-75), so none rounds it to bfloat16 or TF32 alone.
//
// "simt" (body 0): bfloat16 with d not a multiple of 16 or above 128 (gemma's
// 256); float32 only when the caller names it.  One block of 128 threads per
// (query tile of BQ rows, batch*head).  q, k and v are read in their [B, S, H, d] / [B, T,
// KV, d] layouts through their strides, so nothing is transposed or repeated
// in device memory.  The block stages its Q tile once, then walks the K/V
// tiles in order: each is staged in shared memory (converted to float32), the
// BQ x BK scores go to shared memory, one thread per row updates that row's
// running maximum and sum and leaves exp(s - m) in place, and every thread
// rescales and adds to its 4 rows x DMAX/CG output columns held in registers.
// Causal blocks skip the K/V tiles wholly above the diagonal (first column >
// last row of the tile), as the TPU kernel does; the heaviest query tiles are
// scheduled first.  Ragged S and T are handled by bounds: rows past S are
// computed on zeros and never written, columns past T get weight 0.  Q and K
// rows are stored with an odd stride (d + 1) so the score loop reads shared
// memory without bank conflicts.  d must be a multiple of 8 (16-byte loads)
// and at most 256; the tile shapes are chosen by d's bucket (64, 128, 256).
// Bound on the H100: at (B, S, H, KV, d) = (4, 2048, 40, 10, 128), causal,
// float32 (the float32 serve prefill's shape, which "wgmma_f32" runs), one
// launch reads q, k, v once and writes out (419 MB, 0.13 ms at 3.35 TB/s) and
// does 4*d flops per live (row, column) pair (1.72e11 flops, 2.57 ms at 67
// TFLOP/s of float32): it is bound by arithmetic, which this body runs as
// float32 FMAs on the CUDA cores.
//
// "wgmma" (body 1): bfloat16 with d a multiple of 16 up to 128, on the
// tensor cores.  One block of two warpgroups (256 threads) per (128 query
// rows, batch*head), each warpgroup owning 64 rows (wgmma's M); the same
// schedule, causal skip and GQA by index as "simt", and a warpgroup skips a
// causal tile wholly above its own rows.  The Q tile is staged once and K/V
// tiles of 64 keys, shared by both warpgroups, go through a 2-stage ring,
// all with 16-byte cp.async.cg copies written straight into wgmma's
// no-swizzle (INTERLEAVE) layout: the chunk of 8 values at (row r, chunk c)
// lands at ((r/8)*C + c)*128 + (r%8)*16, C chunks a row; rows past S or T
// are zero-filled (V too: p = 0 times a stale NaN is NaN).
//   S = Q.K^T: d/16 wgmma m64n64k16, A and B from shared memory, both
//     K-major (d contiguous as stored); bf16 x bf16 products are exact and
//     summed in float32.
//   Softmax on the accumulator fragments: a thread holds 2 rows x 16
//     columns, so row maxima take two shuffles across its quad.  exp is
//     ex2.approx with log2(e) folded into the scale: p = 2^(s*scale*log2e
//     - m), which differs from exp(s*scale - m) by the rounding of
//     scale*log2e (2^-24 relative) and ex2's 2 ulp, far below the output's
//     bf16 half-ulp of 2^-9.
//   P split: P_hi = bf16(p), P_lo = bf16(p - P_hi), so P_hi + P_lo carries
//     p to ~2^-17 relative; l sums the float32 p.  Rounding P to bf16 alone
//     moves the output by up to 16x the card check's limit (the TPU kernel
//     keeps P in float32); the split costs one more product.
//   O += P_hi.V + P_lo.V: wgmma m64n{DN}k16 with A from registers (the S
//     accumulator of columns 16j..16j+15 is, packed as bf16x2, the A
//     fragment of k-slice j) and V from shared memory as B, MN-major (d
//     contiguous) with the transpose bit.  DN is d rounded up to 32, 64, 96
//     or 128; V's columns d..DN-1 stay zero.  O is float32 in registers.
// Shared memory: (128*d + 2*64*(d + DN))*2 bytes, 96 KB at d = 128; ptxas
// gives the block ~170 registers a thread, so one block runs on an SM.
// Bound on the H100 at (1, 8192, 8192, 40, 10, 128) causal: 6.87e11
// operations, 0.69 ms at 989 TFLOP/s of bf16; the split issues 1.5x that.
// Not yet here: TMA copies, a producer warp, the 128-byte swizzle, and
// overlap of a product with the softmax next to it (the block waits for
// each product before the softmax that reads it).
//
// "wgmma_f32" (body 2): float32 with d a multiple of 8 up to 256, on the
// tensor cores as 3xTF32: a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi with
// x_hi = tf32(x), x_lo = tf32(x - x_hi), both by cvt.rna (to nearest, ties
// away from zero), the products summed in the float32 accumulators.  Three
// products on both Q.K^T and P.V: emulated on the CPU against the card
// check's float32 gate of 1e-4 (tests/test_torch_attention.py), three
// reach 0.017 of it at phi3's heads, one breaks it 8.7x, and dropping any
// one of the six breaks it 2.9x or more.  The same schedule, causal skip,
// GQA by index, masks, zero-fill and ex2 softmax as "wgmma"; P is split
// into P_hi + P_lo in registers (l sums the float32 p).  What TF32 changes:
//   wgmma reads .tf32 operands K-major only (no transpose bit), in k-steps
//     of 8 values (two 16-byte chunks, so the same INTERLEAVE layout and
//     descriptors as "wgmma"'s with 4 values a chunk).  Q.K^T reads Q and
//     K as stored; V is stored transposed, V^T: a row per head-dim column,
//     the tile's keys contiguous.
//   P feeds wgmma m64n{DN}k8 as A from registers.  A thread's A fragment of
//     an 8-key slice is (row g, position t), (g+8, t), (g, t+4), (g+8, t+4)
//     (t = lane % 4, as mma.m16n8k8's tf32 A), while the S accumulator gives
//     it keys 2t and 2t+1; so V^T's keys are permuted within each slice (key
//     j at position (j%2)*4 + j/2) and no shuffle is needed: the sum over
//     keys does not care about their order.
//   One block of two warpgroups (256 threads) per (128 query rows,
//     batch*head), each warpgroup owning 64 rows; K/V tiles of 32 keys,
//     shared by both (at d <= 64 a warpgroup skips the products of a causal
//     tile wholly above its rows, but still copies, splits and meets every
//     barrier; ptxas serializes every wgmma behind that branch, which costs
//     more than the skipped products from d = 96 on).
//   Copies go raw into the lo buffers by cp.async (Q and K 16 bytes a
//     thread; V 4 bytes a thread, transposed on the way, a warp's 32 values
//     on 32 banks) and are split in place, lo -> (hi, lo).
//   Shared memory: the hi and lo halves of Q (128 rows), of K and of V^T,
//     128 + 32 + 32 KB at d = 128 (196,608 bytes, under 227 KB), one slot
//     each for K and V.  A slot's copy and split overlap the other product:
//     V(kt) is split while Q.K(kt)^T runs, K(kt+1) is copied during the
//     softmax and split while P.V(kt) runs, V(kt+1) is copied at the end of
//     the tile.  ptxas gives 158 registers a thread at d = 128.
//   What bounds it is the copies into shared memory, not the products: the
//     time follows the bytes copied per query row, so the two warpgroups
//     share each tile (one warpgroup with tiles of 64 keys, or copying K and
//     V already split into their halves, twice the bytes, was slower).
//   Asked for it (lse not null), the body writes each row's log-sum-exp in
//     base 2 to lse[b, h, row]: lse2 = m + log2(max(l, 1e-30)), m the row's
//     largest s*scale*log2(e) and l its sum of 2^(s*scale*log2(e) - m), the
//     form the softmax above works in, so that B4's backward
//     (flash_attention_bwd.cu) rebuilds P = 2^(s*scale*log2(e) - lse2) with
//     one FMA and one ex2.  One lane of a row's quad writes it beside the
//     output; nothing else changes, so the output has the same bits with and
//     without it.  The primitives shared with the backward are in
//     tf32_wgmma.cuh.
// Bound on the H100 at (4, 2048, 2048, 40, 10, 128) causal: 1.72e11
// float32 operations (2.57 ms at 67 TFLOP/s of float32 FMAs), issued as
// 5.16e11 TF32 operations, 1.04 ms at 495 TFLOP/s; its bytes take 0.13 ms.
//   Above d = 128 (gemma's 256) that block does not fit: Q's halves for 128
//   rows alone take 256 KB, and O's 64 x 256 float32 accumulator takes 128
//   registers a thread.  So one instantiation (flash_attention_tf32_wide,
//   D = 256) serves every width 136 .. 256, the columns past d zero in
//   shared memory, O as one m64n256k8 accumulator, with:
//   - Q kept raw in shared memory (128 KB), never split there: at each of
//     Q.K^T's 32 k-steps a warp loads its A fragment with one ldmatrix (a
//     k-step ahead), splits it into hi and lo in registers and issues the
//     three products with A from registers, two k-steps' products in flight;
//   - K tiles of 32 keys (hi and lo, 64 KB), so that Q.K^T runs at N = 32:
//     with tiles of 16 its 96 products a tile, of N = 16, took ~43 cycles
//     each (8 at the TF32 peak) and bounded the body (bring-up probes);
//   - V^T tiles of 16 keys (hi and lo, 32 KB), two a K tile through one slot:
//     224 KB in all.  The second half's copy waits for the first half's
//     products; K(kt+1) is split meanwhile.
//   There the causal skip is off: each warpgroup runs every tile of the
//   block, so no wgmma sits in a branch ptxas cannot prove uniform.
//   Bound at (4, 2048, 2048, 16, 16, 256) causal: 1.37e11 float32
//   operations, issued as 4.12e11 TF32 ones, 0.83 ms at 495 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

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

// ------------------------------------------------------------- "wgmma" body
namespace wg {

constexpr int kGroups = 2;                // consumer warpgroups a block
constexpr int kWgThreads = 128 * kGroups;
constexpr int kRows = 64 * kGroups;       // query rows of a block: wgmma's M = 64 a warpgroup
constexpr int kKeys = 64;                 // keys of a K/V tile
constexpr float kLog2e = 1.4426950408889634f;

using tfw::cp_async_commit;
using tfw::cp_async_wait_all;
using tfw::ex2;
using tfw::fence_proxy_async;
using tfw::fence_regs;
using tfw::make_desc;
using tfw::smem_addr;
using tfw::wgmma_commit;
using tfw::wgmma_fence;
using tfw::wgmma_wait_all;


// One K/V tile's step of the online softmax, on the accumulator of S =
// Q.K^T (wgmma m64n{2*NS}): s[4j + e] is row row0 + 8*(e/2), column
// k0 + 8j + t2 + e%2.  Keys at or past Tk get -inf (weight 0) and, when
// causal, keys right of a row's diagonal -1e30 (the TPU kernel's mask),
// where the tile reaches past Tk or past the warpgroup's first row
// first_row.  Masks and maxima on the raw scores (the scale is positive);
// p = 2^(s*c - m) with m in scaled units, one FMA before the ex2, left in
// s; l and the output accumulator o rescaled by 2^(m_old - m_new).
template <int NS, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&o)[NO], float (&m)[2],
                                             float (&l)[2], int k0, int Tk, int row0, int t2,
                                             int first_row, int causal, float scale_log2) {
  constexpr int kCols = 2 * NS;
  if (k0 + kCols > Tk || (causal && k0 + kCols - 1 > first_row)) {
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + t2 + (e & 1);
        if (col >= Tk) s[4 * j + e] = __int_as_float(0xff800000);      // -inf: weight 0
        else if (causal && row0 + 8 * (e >> 1) < col) s[4 * j + e] = kNegInf;
      }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float alpha[2], neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Rows r0 .. r0+ROWS-1 into the INTERLEAVE layout by the block's kWgThreads
// threads (tfw::load_tile).
template <int ROWS, int DC, int LDC, typename T>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src, long long row_stride,
                                          int r0, int n_valid, int c_valid = DC) {
  tfw::load_tile<kWgThreads, ROWS, DC, LDC>(dst, src, row_stride, r0, n_valid, c_valid);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S,
                      int Tk, int H, int KV, long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_st, long long k_sh, long long v_sb,
                      long long v_st, long long v_sh, int causal, float scale_log2) {
  constexpr int DN = D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : 128;   // P.V's N
  constexpr int DC = D / 8, CV = DN / 8;           // 16-byte chunks of a Q/K row, of a V row
  constexpr int kQBytes = kRows * D * 2, kKBytes = kKeys * D * 2, kVBytes = kKeys * DN * 2;
  extern __shared__ __align__(128) unsigned char tiles[];
  unsigned char* sQ = tiles;
  unsigned char* sK = sQ + kQBytes;                // 2 stages
  unsigned char* sV = sK + 2 * kKBytes;            // 2 stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = warp / 4;                      // this thread's warpgroup: rows 64*group ..
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest causal tiles first
  const int gq0 = q0 + 64 * group;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  if constexpr (DN > D) {                          // V's columns D..DN-1 stay zero
    constexpr int kPad = CV - DC;
    for (int i = tid; i < 2 * kKeys * kPad; i += kWgThreads) {
      const int stage = i / (kKeys * kPad), j = i % (kKeys * kPad);
      const int r = j / kPad, c = DC + j % kPad;
      *reinterpret_cast<uint4*>(sV + stage * kVBytes + ((r / 8) * CV + c) * 128 + (r % 8) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  int n_tiles = (Tk + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kKeys + 1);
  load_tile<kRows, DC, DC>(sQ, qb, q_ss, q0, S);
  load_tile<kKeys, DC, DC>(sK, kb, k_st, 0, Tk);
  load_tile<kKeys, DC, CV>(sV, vb, v_st, 0, Tk);
  cp_async_commit();

  // Q and K: K-major; chunks c and c+1 (K) 128 B apart, 8-row groups (M or
  // N) DC*128 B apart.  V: MN-major; 8-key groups (K) CV*128 B apart,
  // d-chunks (N) 128 B apart.  A warpgroup's 64 Q rows are 8 row groups.
  const uint32_t q_addr = smem_addr(sQ) + group * 64 * D * 2;
  const uint32_t k_addr = smem_addr(sK), v_addr = smem_addr(sV);
  constexpr uint32_t kQKLbo = 128, kQKSbo = DC * 128, kVLbo = CV * 128, kVSbo = 128;

  float o[DN / 2], s[32];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = gq0 + (warp % 4) * 16 + lane / 4;    // this thread's rows: row0, row0 + 8
  const int t2 = 2 * (lane % 4);                   // and columns 8j + t2, 8j + t2 + 1

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1, k0 = kt * kKeys;
    cp_async_wait_all();                           // this thread's copies of tile kt (and Q)
    fence_proxy_async();
    __syncthreads();                               // everyone's; tile kt-1's products are done
    if (kt + 1 < n_tiles) {                        // into the slot tile kt-1 left
      load_tile<kKeys, DC, DC>(sK + (stage ^ 1) * kKBytes, kb, k_st, k0 + kKeys, Tk);
      load_tile<kKeys, DC, CV>(sV + (stage ^ 1) * kVBytes, vb, v_st, k0 + kKeys, Tk);
      cp_async_commit();
    }
    // a causal tile wholly above this warpgroup's rows adds nothing to them
    if (causal && k0 > gq0 + 63) continue;

    // registers that a wgmma reads are fenced before wgmma.fence, so that no
    // other instruction writes them inside the product's pipeline stage
    const uint32_t k_stage = k_addr + stage * kKBytes;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)            // the first overwrites s
      mma_ss(s, make_desc(q_addr + ks * 256, kQKLbo, kQKSbo),
             make_desc(k_stage + ks * 256, kQKLbo, kQKSbo), ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    softmax_tile(s, o, m, l, k0, Tk, row0, t2, gq0, causal, scale_log2);
    // A fragment of k-slice j, register r: s[8j + 2r] (low half), s[8j + 2r + 1]
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * j + 2 * r], c = s[8 * j + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[j][r] = bits(hi);
        p_lo[j][r] = bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
      }
    const uint32_t v_stage = v_addr + stage * kVBytes;
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t dv = make_desc(v_stage + 2 * j * CV * 128, kVLbo, kVSbo);
      mma_rs(o, p_hi[j], dv);
      mma_rs(o, p_lo[j], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + t2) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                   int H, int KV, const long long* st, int causal, float scale, cudaStream_t stream) {
  constexpr int DN = D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : 128;
  auto kernel = flash_attention_wgmma<D>;
  constexpr size_t smem = static_cast<size_t>(kRows * D + 2 * kKeys * (D + DN)) * 2;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, Tk, H, KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, scale * kLog2e);
  return cudaGetLastError();
}

// d a multiple of 16 up to 128, one instantiation each
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                       int H, int KV, int d, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(q, k, v, out, B, S, Tk, H, KV, st, causal, scale, stream);
    case 32: return launch<32>(q, k, v, out, B, S, Tk, H, KV, st, causal, scale, stream);
    case 48: return launch<48>(q, k, v, out, B, S, Tk, H, KV, st, causal, scale, stream);
    case 64: return launch<64>(q, k, v, out, B, S, Tk, H, KV, st, causal, scale, stream);
    case 80: return launch<80>(q, k, v, out, B, S, Tk, H, KV, st, causal, scale, stream);
    case 96: return launch<96>(q, k, v, out, B, S, Tk, H, KV, st, causal, scale, stream);
    case 112: return launch<112>(q, k, v, out, B, S, Tk, H, KV, st, causal, scale, stream);
    case 128: return launch<128>(q, k, v, out, B, S, Tk, H, KV, st, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

// ---------------------------------------------------------- "wgmma_f32" body
namespace tf {

using tfw::cp_async_commit;
using tfw::fence_proxy_async;
using tfw::fence_regs;
using tfw::make_desc;
using tfw::smem_addr;
using tfw::wgmma_commit;
using tfw::wgmma_fence;
using tfw::wgmma_wait_all;
using wg::kRows;                          // the block is "wgmma"'s: two warpgroups of 64 query rows
using wg::kWgThreads;
using wg::load_tile;
using wg::softmax_tile;

constexpr int kKeys = 32;                 // keys of a K/V tile up to d = 128, of a K tile above
constexpr int kHalf = 16;                 // keys of a V^T tile above d = 128
constexpr int kWideD = 256;               // the one instantiation above d = 128

using tfw::cp_async_wait;
using tfw::ldmatrix_x4;
using tfw::mma_rs;
using tfw::mma_ss;
using tfw::tf32;
using tfw::wgmma_wait;

// V^T tiles and in-place splits by the block's kWgThreads threads
// (tfw::load_vt, tfw::split).
template <int D, int KEYS>
__device__ __forceinline__ void load_vt(unsigned char* dst, const float* src, long long row_stride,
                                        int k0, int n_valid, int d_valid) {
  tfw::load_vt<kWgThreads, D, KEYS>(dst, src, row_stride, k0, n_valid, d_valid);
}
template <int BYTES, int UNROLL = 4>
__device__ __forceinline__ void split(unsigned char* hi, unsigned char* lo) {
  tfw::split<kWgThreads, BYTES, UNROLL>(hi, lo);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_tf32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                     int S, int Tk, int H,
                     int KV, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
                     int causal, float scale_log2) {
  constexpr int DN = D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : 128;   // P.V's N
  constexpr int C = D / 4;                          // 16-byte chunks of a Q/K row
  constexpr int kQBytes = kRows * D * 4, kKBytes = kKeys * D * 4, kVBytes = DN * kKeys * 4;
  constexpr int kVRowBytes = D * kKeys * 4;         // V^T's rows 0..D-1; D..DN-1 stay zero
  constexpr bool kSkip = D <= 64;                   // see the causal skip below
  extern __shared__ __align__(128) unsigned char tiles[];
  unsigned char* sQh = tiles;
  unsigned char* sQl = sQh + kQBytes;
  unsigned char* sKh = sQl + kQBytes;
  unsigned char* sKl = sKh + kKBytes;
  unsigned char* sVh = sKl + kKBytes;
  unsigned char* sVl = sVh + kVBytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = warp / 4;                      // this thread's warpgroup: rows 64*group ..
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest causal tiles first
  const int gq0 = q0 + 64 * group;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  if constexpr (DN > D) {
    for (int i = kVRowBytes + tid * 16; i < kVBytes; i += kWgThreads * 16) {
      *reinterpret_cast<uint4*>(sVh + i) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(sVl + i) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  int n_tiles = (Tk + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kKeys + 1);
  load_tile<kRows, C, C>(sQl, qb, q_ss, q0, S);
  load_tile<kKeys, C, C>(sKl, kb, k_st, 0, Tk);
  cp_async_commit();
  load_vt<D, kKeys>(sVl, vb, v_st, 0, Tk, D);
  cp_async_commit();
  cp_async_wait<1>();                              // Q and K(0), not V(0)
  __syncthreads();
  split<kQBytes>(sQh, sQl);
  split<kKBytes>(sKh, sKl);
  fence_proxy_async();
  __syncthreads();

  // Q and K: chunks c and c+1 (K) 128 B apart, 8-row groups C*128 B apart;
  // a warpgroup's 64 Q rows are 8 row groups.  V^T: chunks of 4 keys 128 B
  // apart, 8-column groups (kKeys/4)*128 B apart.  A k-step of 8 values is
  // two chunks, 256 B further: its descriptor is the first one plus
  // 256 >> 4 = 16 in the address field.
  constexpr uint32_t kLbo = 128, kQKSbo = C * 128, kVSbo = (kKeys / 4) * 128;
  const uint32_t q_rows = group * 64 * D * 4;
  const uint64_t dqh = make_desc(smem_addr(sQh) + q_rows, kLbo, kQKSbo);
  const uint64_t dql = make_desc(smem_addr(sQl) + q_rows, kLbo, kQKSbo);
  const uint64_t dkh = make_desc(smem_addr(sKh), kLbo, kQKSbo), dkl = make_desc(smem_addr(sKl), kLbo, kQKSbo);
  const uint64_t dvh = make_desc(smem_addr(sVh), kLbo, kVSbo), dvl = make_desc(smem_addr(sVl), kLbo, kVSbo);

  float o[DN / 2], s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = gq0 + (warp % 4) * 16 + lane / 4;    // this thread's rows: row0, row0 + 8
  const int t2 = 2 * (lane % 4);                   // and columns 8j + t2, 8j + t2 + 1

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    const bool more = kt + 1 < n_tiles;
    // a causal tile wholly above this warpgroup's rows adds nothing to them;
    // the warpgroup still copies, splits and meets every barrier.  Only at
    // d <= 64 does it skip that tile's products: the skip is a branch ptxas
    // cannot prove uniform across the warpgroup, so it serializes every
    // wgmma of the kernel, which costs more than the skipped products from
    // d = 96 on and less at 64 (bring-up probes)
    const bool live = !(kSkip && causal && k0 > gq0 + 63);
    if (live) {                                    // S = Q_hi.K_hi + Q_hi.K_lo + Q_lo.K_hi
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {          // the first overwrites s
        mma_ss(s, dqh + 16 * ks, dkh + 16 * ks, ks > 0);
        mma_ss(s, dqh + 16 * ks, dkl + 16 * ks, 1);
        mma_ss(s, dql + 16 * ks, dkh + 16 * ks, 1);
      }
      wgmma_commit();
    }
    // while the tensor cores run it: V(kt), landed, split in place
    cp_async_wait<0>();
    __syncthreads();
    split<kVRowBytes>(sVh, sVl);
    fence_proxy_async();
    if (live) {
      wgmma_wait_all();
      fence_regs(s);
    }
    __syncthreads();                               // every S(kt) product done: K's slot is free
    if (more) {
      load_tile<kKeys, C, C>(sKl, kb, k_st, k0 + kKeys, Tk);
      cp_async_commit();
    }

    // P's halves stay live until the products that read them are done
    uint32_t p_hi[kKeys / 8][4], p_lo[kKeys / 8][4];
    if (live) {
      softmax_tile(s, o, m, l, k0, Tk, row0, t2, gq0, causal, scale_log2);
      // A fragment of k-slice j: (row g, position t), (g + 8, t), (g, t + 4),
      // (g + 8, t + 4); positions t and t + 4 hold keys 2t and 2t + 1 (V^T's
      // permutation), which are this thread's s[4j], s[4j + 2], s[4j + 1], s[4j + 3]
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float a[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float hi = tf32(a[r]);
          p_hi[j][r] = __float_as_uint(hi);
          p_lo[j][r] = __float_as_uint(tf32(a[r] - hi));
        }
      }
      // O += P_hi.V_hi + P_hi.V_lo + P_lo.V_hi
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        mma_rs(o, p_hi[j], dvh + 16 * j);
        mma_rs(o, p_hi[j], dvl + 16 * j);
        mma_rs(o, p_lo[j], dvh + 16 * j);
      }
      wgmma_commit();
    }
    if (more) {                                    // while they run: K(kt+1), landed, split
      cp_async_wait<0>();
      __syncthreads();
      split<kKBytes>(sKh, sKl);
      fence_proxy_async();
    }
    if (live) {
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
    }
    __syncthreads();                               // every P.V(kt) product done: V's slot is free
    if (more) {
      load_vt<D, kKeys>(sVl, vb, v_st, k0 + kKeys, Tk, D);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && t2 == 0) lse[(static_cast<long long>(b) * H + h) * S + row] = m[r] + log2f(denom);
    float* orow = out + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + t2) =
          make_float2(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
  }
}

// "wgmma_f32" above d = 128 (see the note): Q raw, K tiles of 32 keys, V^T
// tiles of 16, no causal skip.  Its in-place splits run two float4s at a
// time: at four, beside O's 128 accumulators, ptxas spilled.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_tf32_wide(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          float* __restrict__ lse, int S, int Tk, int H, int KV, int d, long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_st, long long k_sh, long long v_sb,
                          long long v_st, long long v_sh, int causal, float scale_log2) {
  constexpr int C = D / 4;                          // 16-byte chunks of a Q/K row
  constexpr int kQBytes = kRows * D * 4, kKBytes = kKeys * D * 4, kVBytes = D * kHalf * 4;
  extern __shared__ __align__(128) unsigned char tiles[];
  unsigned char* sQ = tiles;
  unsigned char* sKh = sQ + kQBytes;
  unsigned char* sKl = sKh + kKBytes;
  unsigned char* sVh = sKl + kKBytes;
  unsigned char* sVl = sVh + kVBytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = warp / 4;                      // this thread's warpgroup: rows 64*group ..
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest causal tiles first
  const int gq0 = q0 + 64 * group;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  int n_tiles = (Tk + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kKeys + 1);
  load_tile<kRows, C, C>(sQ, qb, q_ss, q0, S, d / 4);
  load_tile<kKeys, C, C>(sKl, kb, k_st, 0, Tk, d / 4);
  cp_async_commit();
  load_vt<D, kHalf>(sVl, vb, v_st, 0, Tk, d);
  cp_async_commit();
  cp_async_wait<1>();                              // Q and K(0), not V(0)
  __syncthreads();
  split<kKBytes, 2>(sKh, sKl);
  fence_proxy_async();
  __syncthreads();

  // K: chunks c and c+1 (K) 128 B apart, 8-key groups C*128 B apart; a
  // k-step is 256 B further (+16 in the descriptor).  V^T: chunks of 4 keys
  // 128 B apart, 8-column groups (kHalf/4)*128 B apart.  Q's A fragment for
  // ldmatrix: matrix i = lane/8 is the core matrix of row group i%2 of the
  // warp's 16 rows and chunk i/2 of the k-step, so that register i holds
  // (row g + 8*(i%2), column t + 4*(i/2)), wgmma's tf32 A fragment.
  constexpr uint32_t kLbo = 128, kKSbo = C * 128, kVSbo = (kHalf / 4) * 128;
  const uint64_t dkh = make_desc(smem_addr(sKh), kLbo, kKSbo), dkl = make_desc(smem_addr(sKl), kLbo, kKSbo);
  const uint64_t dvh = make_desc(smem_addr(sVh), kLbo, kVSbo), dvl = make_desc(smem_addr(sVl), kLbo, kVSbo);
  const uint32_t q_frag =
      smem_addr(sQ) + ((group * 8 + 2 * (warp % 4) + (lane / 8) % 2) * C + lane / 16) * 128 + (lane % 8) * 16;

  float o[D / 2], s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = gq0 + (warp % 4) * 16 + lane / 4;    // this thread's rows: row0, row0 + 8
  const int t2 = 2 * (lane % 4);                   // and columns 8j + t2, 8j + t2 + 1

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    const bool more = kt + 1 < n_tiles;
    // S = Q_hi.K_hi + Q_hi.K_lo + Q_lo.K_hi
    fence_regs(s);
    uint32_t raw[4];
    ldmatrix_x4(raw, q_frag);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {            // the first overwrites s
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = __uint_as_float(raw[r]), xh = tf32(x);
        hi[r] = __float_as_uint(xh);
        lo[r] = __float_as_uint(tf32(x - xh));
      }
      if (ks + 1 < D / 8) ldmatrix_x4(raw, q_frag + 256 * (ks + 1));
      wgmma_fence();
      mma_rs(s, hi, dkh + 16 * ks, ks > 0);
      mma_rs(s, hi, dkl + 16 * ks);
      mma_rs(s, lo, dkh + 16 * ks);
      wgmma_commit();
      wgmma_wait<1>();
    }
    // while the last ones run: V(kt)'s first half, landed, split in place
    cp_async_wait<0>();
    __syncthreads();
    split<kVBytes, 2>(sVh, sVl);
    fence_proxy_async();
    wgmma_wait_all();
    fence_regs(s);
    __syncthreads();                               // every S(kt) product done: K's slot is free
    if (more) {
      load_tile<kKeys, C, C>(sKl, kb, k_st, k0 + kKeys, Tk, d / 4);
      cp_async_commit();
    }

    softmax_tile(s, o, m, l, k0, Tk, row0, t2, gq0, causal, scale_log2);
    // O += P_hi.V_hi + P_hi.V_lo + P_lo.V_hi, keys k0 .. k0 + 15 and then
    // k0 + 16 .. k0 + 31, each half through V^T's slot, P split a half at a
    // time (the second half's p waits in s)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // A fragment of k-slice j: positions t and t + 4 hold keys 2t and
      // 2t + 1 (V^T's permutation): this thread's s[4j], s[4j + 2], s[4j + 1],
      // s[4j + 3]
      uint32_t p_hi[kHalf / 8][4], p_lo[kHalf / 8][4];
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const int js = 2 * half + j;
        const float a[4] = {s[4 * js], s[4 * js + 2], s[4 * js + 1], s[4 * js + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float hi = tf32(a[r]);
          p_hi[j][r] = __float_as_uint(hi);
          p_lo[j][r] = __float_as_uint(tf32(a[r] - hi));
        }
      }
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        mma_rs(o, p_hi[j], dvh + 16 * j);
        mma_rs(o, p_hi[j], dvl + 16 * j);
        mma_rs(o, p_lo[j], dvh + 16 * j);
      }
      wgmma_commit();
      if (half == 0 && more) {                     // while they run: K(kt+1), landed, split
        cp_async_wait<0>();
        __syncthreads();
        split<kKBytes, 2>(sKh, sKl);
        fence_proxy_async();
      }
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      __syncthreads();                             // every P.V product of this half done: V's slot is free
      if (half == 0) {                             // V(kt)'s second half, into the slot and split
        load_vt<D, kHalf>(sVl, vb, v_st, k0 + kHalf, Tk, d);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        split<kVBytes, 2>(sVh, sVl);
        fence_proxy_async();
        __syncthreads();
      } else if (more) {
        load_vt<D, kHalf>(sVl, vb, v_st, k0 + kKeys, Tk, d);
        cp_async_commit();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && t2 == 0) lse[(static_cast<long long>(b) * H + h) * S + row] = m[r] + log2f(denom);
    float* orow = out + ((static_cast<long long>(b) * S + row) * H + h) * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<float2*>(orow + 8 * j + t2) =
            make_float2(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S, int Tk,
                   int H, int KV, const long long* st, int causal, float scale, cudaStream_t stream) {
  constexpr int DN = D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : 128;
  auto kernel = flash_attention_tf32<D>;
  constexpr size_t smem = static_cast<size_t>(2 * kRows * D + 2 * kKeys * D + 2 * DN * kKeys) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, S, Tk, H, KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, scale * wg::kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
                        int Tk, int H, int KV, int d, const long long* st, int causal, float scale,
                        cudaStream_t stream) {
  constexpr int D = kWideD;
  auto kernel = flash_attention_tf32_wide<D>;
  constexpr size_t smem = static_cast<size_t>(kRows * D + 2 * kKeys * D + 2 * D * kHalf) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, S, Tk, H, KV, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, scale * wg::kLog2e);
  return cudaGetLastError();
}

// d a multiple of 8: one instantiation each up to 128, the wide one above
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
                       int Tk, int H, int KV, int d, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  if (d > 128) return launch_wide(q, k, v, out, lse, B, S, Tk, H, KV, d, st, causal, scale, stream);
#define TF_CASE(D) \
  case D: return launch<D>(q, k, v, out, lse, B, S, Tk, H, KV, st, causal, scale, stream);
  switch (d) {
    TF_CASE(8) TF_CASE(16) TF_CASE(24) TF_CASE(32) TF_CASE(40) TF_CASE(48) TF_CASE(56) TF_CASE(64)
    TF_CASE(72) TF_CASE(80) TF_CASE(88) TF_CASE(96) TF_CASE(104) TF_CASE(112) TF_CASE(120) TF_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef TF_CASE
}

}  // namespace tf

}  // namespace

// body: 0 "simt", 1 "wgmma" (bfloat16, d a multiple of 16 up to 128),
// 2 "wgmma_f32" (float32, d a multiple of 8 up to 256).
// dtype: 0 float32, 1 bfloat16.  q [B,S,H,d], k/v [B,T,KV,d] with unit last
// stride; strides in elements: q (batch, seq, head), k (batch, seq, head),
// v (batch, seq, head).  out is a contiguous [B,S,H,d] of the same type.
// lse: null, or (body 2 only) a contiguous [B,H,S] float32 that receives
// each row's log-sum-exp in base 2, lse2 = m + log2(l) (see the note);
// out's bits are the same either way.
// Returns the CUDA error of the launch (0 on success); cudaErrorInvalidValue
// for a shape or a body it cannot take.
extern "C" int flash_attention_fwd(int body, int dtype, const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int S, int Tk, int H, int KV, int d,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh,
                                   int causal, float scale, void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || KV <= 0 || H % KV != 0 || B * H > 65535 ||
      (dtype != 0 && dtype != 1) || body < 0 || body > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == 1 && (dtype != 1 || d % 16 != 0 || d > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((body == 2 && dtype != 0) || (lse != nullptr && body != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (body == 1)
    err = wg::dispatch_d(q, k, v, out, B, S, Tk, H, KV, d, st, causal, scale, s);
  else if (body == 2)
    err = tf::dispatch_d(q, k, v, out, static_cast<float*>(lse), B, S, Tk, H, KV, d, st, causal, scale, s);
  else if (dtype == 0)
    err = dispatch_d<float>(q, k, v, out, B, S, Tk, H, KV, d, st, causal, scale, s);
  else
    err = dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, KV, d, st, causal, scale, s);
  return static_cast<int>(err);
}
