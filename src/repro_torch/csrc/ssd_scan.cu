// Mamba-2 SSD chunk scan (state-space duality, arXiv:2405.21060).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::
// ssd_scan_kernel (body _ssd_kernel).  For one (batch b, head h) the
// sequence is cut into chunks of Q positions that run in order and carry
// the state h in float32[P, N].  Inside a chunk, with the log-decay
// la_t = dt_t * a and acs its inclusive cumulative sum,
//     y_t = sum_{s<=t} (C_t . B_s) exp(acs_t - acs_s) x_s dt_s      (intra-chunk)
//         + exp(acs_t) (C_t . h[p, :])                            (inter-chunk)
//     h  <- exp(acs_{Q-1}) h + sum_s exp(acs_{Q-1} - acs_s) (x_s dt_s) (x) B_s
// The y of a chunk reads the chunk's incoming h; h is updated after it.
// Float32 throughout.  acs is summed in float64 and rounded once to
// float32, as the plain version (kernels/ssd_scan/ref.py) does: at the
// serve shape it reaches about -2,000 at the end of a chunk of 1,024, where
// a float32 running sum would carry an error of ~1e-3 that depends on the
// order of the adds.
//
// Design: one block of 256 threads per (b, h) walks its chunks in order
// and keeps h in shared memory (transposed, [N][P]) from the first chunk to
// the last.  The Pallas kernel holds the chunk's whole Q x Q decay matrix
// and scores in VMEM; at Q = 1,024 that is 4 MB, against 227 KB of shared
// memory a block here.  So the chunk is tiled: for each tile of 64 rows t,
// the block stages C_t, starts the y tile with the inter-chunk term, then
// for each tile of 64 columns s <= t stages B_s and x_s dt_s, forms the
// 64 x 64 scores C_t B_s^T, scales them by exp(acs_t - acs_s) (0 above the
// diagonal) and adds scores . (x dt)_s into the y tile, which stays in
// registers.  After every row tile, a second pass over the column tiles
// builds the chunk's contribution to h.  Each product is a 64-row tile in
// which a thread owns a 4 x 4 block of outputs, read as float4 from shared
// memory laid out so that a warp's reads are broadcasts or contiguous.
// 136 KB of shared memory at P = 64, N = 128, Q = 1,024: above the 48 KB
// default, so the launch raises the block's dynamic limit first.
//
// Layout: x [B, S, H, P], dt [B, S, H], B and C [B, S, N] and a [H] are
// read through strides (B and C have no head stride: the model's bc
// projection is shared by all heads, so every head reads the same rows);
// y is a contiguous [B, S, H, P] and the final state a contiguous
// [B, H, P, N].  The state starts at zero.  P and N are multiples of 4,
// P <= 64, N <= 256.
//
// Bound on the H100: at the serve shape (B, S, H, P, N, Q) = (4, 8192, 32,
// 64, 128, 1024) the function needs about 1.1e11 float32 operations (the
// causal half of C B^T once per batch and chunk, since the heads share B
// and C, and per head the decay, scores . x dt and the two state products),
// 1.6 ms at 67 TFLOP/s, against 0.17 ms to move its 0.58 GB: it is bound by
// operations.  This kernel does 2.5e11 on the CUDA cores, because each head
// forms C B^T again (32 times over at 32 heads), and one block per (b, h)
// fills only B*H of the 132 SMs.  Sharing C B^T across heads, a separate
// state pass that frees the chunks to run in parallel, and the tensor cores
// are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;                  // rows (and columns) of a tile of the chunk
constexpr int kLdS = kT + 4;            // row stride of the staged scores
constexpr int kMaxStateTiles = 4;       // 4 x 4 blocks of h a thread owns: (P/4)(N/4) <= 1024

struct Strides {
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s, a_h;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// Shared memory, in floats: h, acs, C tile, B tile, x dt tile, scores.
__host__ __device__ inline size_t smem_floats(int P, int N, int Q) {
  return static_cast<size_t>(N) * P + round4(Q) + static_cast<size_t>(2) * N * kT +
         static_cast<size_t>(kT) * P + static_cast<size_t>(kT) * kLdS;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

// Rows row0 .. row0 + kT - 1 of a [rows, W] view (row stride in elements,
// unit column stride) into shared memory column-major, dst[k * kT + i];
// rows at or past n_valid are zero.  Consecutive threads take consecutive
// rows, so the transposed writes hit consecutive banks.
__device__ __forceinline__ void load_kmajor(float* dst, const float* src, long long row_stride,
                                            int row0, int n_valid, int W) {
  for (int e = threadIdx.x; e < kT * (W / 4); e += kThreads) {
    const int i = e % kT, k = (e / kT) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n_valid) v = ld4(src + static_cast<long long>(row0 + i) * row_stride + k);
    dst[(k + 0) * kT + i] = v.x;
    dst[(k + 1) * kT + i] = v.y;
    dst[(k + 2) * kT + i] = v.z;
    dst[(k + 3) * kT + i] = v.w;
  }
}

// The same rows row-major, dst[i * W + k], each row times scale[i] when
// scale is given; rows at or past n_valid are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long row_stride,
                                          int row0, int n_valid, int W, const float* scale) {
  const int w4 = W / 4;
  for (int e = threadIdx.x; e < kT * w4; e += kThreads) {
    const int i = e / w4, k = (e - i * w4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n_valid) {
      v = ld4(src + static_cast<long long>(row0 + i) * row_stride + k);
      if (scale != nullptr) {
        const float s = scale[i];
        v.x *= s; v.y *= s; v.z *= s; v.w *= s;
      }
    }
    st4(dst + i * W + k, v);
  }
}

// acs[0..Q) <- inclusive cumsum of acs[0..Q) in float64, rounded to float32,
// by one warp: each lane sums its segment, the lanes scan their sums, and
// each lane walks its segment again from its offset.
__device__ void warp_cumsum(float* acs, int Q) {
  const int lane = threadIdx.x & 31;
  const int seg = (Q + 31) / 32;
  const int lo = min(Q, lane * seg), hi = min(Q, lo + seg);
  double part = 0.0;
  for (int k = lo; k < hi; ++k) part += static_cast<double>(acs[k]);
  double incl = part;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  double acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.0;
  for (int k = lo; k < hi; ++k) {
    acc += static_cast<double>(acs[k]);
    acs[k] = static_cast<float>(acc);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, float* __restrict__ y, float* __restrict__ h_out,
                int S, int H, int P, int N, int Q, Strides st) {
  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;     // a thread's 4 x 4 block in a 64 x 64 tile
  const bool ycols = tx * 4 < P;              // owns columns of the y tile

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sH = smem;                           // [N][P]: h transposed
  float* sAcs = sH + N * P;                   // [Q], then the x dt row scale of a pass
  float* sC = sAcs + round4(Q);               // [N][kT]
  float* sB = sC + N * kT;                    // [N][kT] (y pass) or [kT][N] (state pass)
  float* sX = sB + N * kT;                    // [kT][P]: x dt, times the decay in the state pass
  float* sS = sX + kT * P;                    // [kT][kLdS]: scores transposed
  __shared__ float sScale[kT];                // dt of the staged rows

  const float* xb = x + b * st.x_b + hh * st.x_h;
  const float* dtb = dt + b * st.dt_b + hh * st.dt_h;
  const float* bb = bm + b * st.b_b;           // B and C are shared by the heads
  const float* cb = cm + b * st.c_b;
  const float a_head = a[hh * st.a_h];
  const long long y_row = static_cast<long long>(H) * P;
  float* yb = y + (static_cast<long long>(b) * S * H + hh) * P;
  const long long h_off = static_cast<long long>(bh) * P * N;

  for (int e = tid; e < P * N; e += kThreads) sH[e] = 0.f;
  const int n_tiles = (Q + kT - 1) / kT;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();                          // the previous chunk's readers of acs are done
    for (int t = tid; t < Q; t += kThreads)
      sAcs[t] = __fmul_rn(dtb[static_cast<long long>(c0 + t) * st.dt_s], a_head);
    __syncthreads();
    if (tid < 32) warp_cumsum(sAcs, Q);
    __syncthreads();

    // ---- y: row tiles of the chunk
    for (int tt = 0; tt < n_tiles; ++tt) {
      const int t0 = tt * kT, rows = min(kT, Q - t0);
      load_kmajor(sC, cb, st.c_s, c0 + t0, rows, N);
      __syncthreads();
      float acc[4][4] = {};
      if (ycols) {                            // inter-chunk: exp(acs_t) C_t . h
#pragma unroll 4
        for (int n = 0; n < N; ++n) outer4(acc, ld4(sC + n * kT + ty * 4), ld4(sH + n * P + tx * 4));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int li = ty * 4 + r;
          const float dec = li < rows ? expf(sAcs[t0 + li]) : 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] *= dec;
        }
      }
      for (int ss = 0; ss <= tt; ++ss) {
        const int s0 = ss * kT, cols = min(kT, Q - s0);
        __syncthreads();                      // readers of the previous B, x dt and scores are done
        for (int j = tid; j < kT; j += kThreads)
          sScale[j] = j < cols ? dtb[static_cast<long long>(c0 + s0 + j) * st.dt_s] : 0.f;
        load_kmajor(sB, bb, st.b_s, c0 + s0, cols, N);
        __syncthreads();
        load_rows(sX, xb, st.x_s, c0 + s0, cols, P, sScale);
        float sc[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) outer4(sc, ld4(sC + n * kT + ty * 4), ld4(sB + n * kT + tx * 4));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int lj = tx * 4 + c, j = s0 + lj;
          float4 col;
          float* cv = reinterpret_cast<float*>(&col);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int li = ty * 4 + r, i = t0 + li;
            cv[r] = (li < rows && lj < cols && j <= i) ? sc[r][c] * expf(sAcs[i] - sAcs[j]) : 0.f;
          }
          st4(sS + lj * kLdS + ty * 4, col);
        }
        __syncthreads();
        if (ycols) {
          const int jn = (ss == tt) ? min(cols, ty * 4 + 4) : cols;   // scores past the diagonal are 0
          for (int j = 0; j < jn; ++j) outer4(acc, ld4(sS + j * kLdS + ty * 4), ld4(sX + j * P + tx * 4));
        }
      }
      if (ycols) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int li = ty * 4 + r;
          if (li < rows)
            st4(yb + static_cast<long long>(c0 + t0 + li) * y_row + tx * 4,
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
        }
      }
    }

    // ---- h <- exp(acs_last) h + sum_s exp(acs_last - acs_s) (x dt)_s (x) B_s
    const float acs_last = sAcs[Q - 1];
    const int n4 = N / 4, state_tiles = (P / 4) * n4;
    float hacc[kMaxStateTiles][4][4] = {};
    for (int ss = 0; ss < n_tiles; ++ss) {
      const int s0 = ss * kT, cols = min(kT, Q - s0);
      __syncthreads();
      for (int j = tid; j < kT; j += kThreads)
        sScale[j] = j < cols ? __fmul_rn(dtb[static_cast<long long>(c0 + s0 + j) * st.dt_s],
                                         expf(acs_last - sAcs[s0 + j]))
                             : 0.f;
      load_rows(sB, bb, st.b_s, c0 + s0, cols, N, nullptr);
      __syncthreads();
      load_rows(sX, xb, st.x_s, c0 + s0, cols, P, sScale);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kMaxStateTiles; ++u) {
        const int tile = tid + u * kThreads;
        if (tile < state_tiles) {
          const int pg = (tile / n4) * 4, ng = (tile % n4) * 4;
          for (int j = 0; j < cols; ++j) outer4(hacc[u], ld4(sX + j * P + pg), ld4(sB + j * N + ng));
        }
      }
    }
    const float decay = expf(acs_last);
#pragma unroll
    for (int u = 0; u < kMaxStateTiles; ++u) {
      const int tile = tid + u * kThreads;
      if (tile < state_tiles) {
        const int pg = (tile / n4) * 4, ng = (tile % n4) * 4;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float* hp = sH + (ng + c) * P + pg + r;   // only this thread touches it
            *hp = fmaf(decay, *hp, hacc[u][r][c]);
          }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    h_out[h_off + e] = sH[n * P + p];
  }
}

}  // namespace

// Dynamic shared memory of a launch, in bytes; above the card's 227 KB per
// block the launch fails.
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Q) {
  return static_cast<long long>(sizeof(float) * smem_floats(P, N, Q));
}

// x, dt, bm (B), cm (C), a: float32 views read through the strides below
// (in elements; unit last stride for x, B and C, 16-byte aligned rows; B
// and C have no head stride, as every head reads the same rows); y a
// contiguous [B, S, H, P] and h_out a contiguous [B, H, P, N], the final
// state from a zero start.  Q is the chunk length (S a multiple of it).  Returns the CUDA error of the launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* bm, const void* cm,
                            const void* a, void* y, void* h_out,
                            int B, int S, int H, int P, int N, int Q,
                            long long x_b, long long x_s, long long x_h,
                            long long dt_b, long long dt_s, long long dt_h,
                            long long b_b, long long b_s, long long c_b, long long c_s,
                            long long a_h, void* stream) {
  if (P < 4 || P > 64 || P % 4 != 0 || N < 4 || N > 256 || N % 4 != 0 || Q < 1 || S % Q != 0 ||
      B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s, a_h};
  const size_t smem = sizeof(float) * smem_floats(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(h_out), S, H, P, N, Q, st);
  return static_cast<int>(cudaGetLastError());
}
