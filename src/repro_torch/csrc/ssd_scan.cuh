// Kernel B6's shared pieces: the tiles, the products on the CUDA cores, the
// float64 cumulative sum, and the bodies of the three phases that the
// forward (csrc/ssd_scan.cu) and its backward (csrc/ssd_scan_bwd.cu) both
// run: acs, cb and chunk_state.  Each source wraps them in kernels of its
// own names (ssd_scan_*_kernel, ssd_bwd_*_kernel), so that a profile tells
// the forward's time from the backward's.  See csrc/ssd_scan.cu's note for
// the layout and the design.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;               // rows (and columns) of a tile of the chunk
constexpr int kTileThreads = 64;     // cb and chunk_scan: a 64 x 64 tile, 8 x 8 a thread
constexpr int kScanK = 32;           // positions s (columns of a tile) a chunk_scan stage
constexpr int kScanBlocks = 6;       // chunk_scan blocks an SM holds (by its 33.5 KB of shared memory)
constexpr int kScanStages = kT / kScanK;
constexpr int kStateThreads = 128;   // chunk_state: a 128 x 64 tile, 8 x 8 a thread
constexpr int kStateRows = 128;      // state columns n a chunk_state block
constexpr int kStateK = 32;          // positions a chunk_state stage
constexpr int kAcsWarps = 4;         // (b, chunk, h) rows an acs block
constexpr int kPassThreads = 256;
constexpr int kPassN = 32;           // state rows n a state_pass block

struct Strides {
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s, a_h;
};

struct Dims {
  int B, S, H, P, N, Q;
  int nc, nt, pairs, qp;             // chunks, 64-row tiles a chunk, tiles on and below the diagonal, nt * 64
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

Dims dims(int B, int S, int H, int P, int N, int Q) {
  const int nt = ceil_div(Q, kT);
  return Dims{B, S, H, P, N, Q, S / Q, nt, nt * (nt + 1) / 2, nt * kT};
}

// Scratch, in floats: acs, dt and dt exp(acs_end - acs) [B][nc][H][3][qp];
// cb tiles [B][nc][pairs][kT][kT], tile (t, s) at pair t (t + 1) / 2 + s,
// stored [s-position][t-position]; the chunk states S_c^T and the incoming
// states h_in[c]^T, each [B][nc][H][N][P].
struct Scratch {
  float *ad, *cb, *st, *hin;
};

long long ad_floats(const Dims& d) { return 3LL * d.B * d.nc * d.H * d.qp; }
long long cb_floats(const Dims& d) { return static_cast<long long>(d.B) * d.nc * d.pairs * kT * kT; }
long long st_floats(const Dims& d) { return static_cast<long long>(d.B) * d.nc * d.H * d.N * d.P; }

Scratch carve(float* base, const Dims& d) {
  float* st = base + ad_floats(d) + cb_floats(d);
  return Scratch{base, base + ad_floats(d), st, st + st_floats(d)};
}

constexpr size_t kStateSmem = sizeof(float) * (2 * kStateK * kStateRows + 2 * kStateK * kT + 2 * kStateK);
constexpr size_t kScanSmem = sizeof(float) * (4 * kScanK * kT + kT + 4 * kScanK);

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// kRows rows of kW floats into dst[r * kW + k] by cp.async: row r reads
// src + r * stride; rows at or past n_rows and columns at or past width
// (a multiple of 4) are zero.
template <int kRows, int kW, int kThreads>
__device__ __forceinline__ void async_rows(float* dst, const float* src, long long stride, int n_rows,
                                           int width) {
  constexpr int kChunks = kW / 4;
  for (int e = threadIdx.x; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, k = (e - r * kChunks) * 4;
    const bool ok = r < n_rows && k < width;
    cp_async16(dst + r * kW + k, ok ? src + r * stride + k : src, ok);
  }
}

// The kT x kDepth block of a [rows, width] view (row stride in elements,
// unit column stride) transposed into dst[k * kT + r]; rows at or past
// n_rows and columns at or past width are zero.  Consecutive threads take
// consecutive rows, so the transposed writes hit consecutive banks.
template <int kDepth, int kThreads>
__device__ __forceinline__ void load_transposed(float* dst, const float* src, long long stride, int n_rows,
                                                int width) {
  for (int e = threadIdx.x; e < kT * (kDepth / 4); e += kThreads) {
    const int r = e % kT, k = (e / kT) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && k < width) v = ld4(src + r * stride + k);
    dst[(k + 0) * kT + r] = v.x;
    dst[(k + 1) * kT + r] = v.y;
    dst[(k + 2) * kT + r] = v.z;
    dst[(k + 3) * kT + r] = v.w;
  }
}

// A thread's 8 x 8 block of a product on the CUDA cores: rows i0 .. i0 + 3
// and i0 + kHalf .. i0 + kHalf + 3 of the left operand a, stored k-major
// (row stride kLda), and columns p0 .. p0 + 3 and p0 + 32 .. p0 + 35 of
// the right one b (row stride kLdb), each of b's rows times scale[k] when
// kScaled: acc[r][c] += sum_{k < kn} a[k][row r] b[k][column c].  Threads
// are laid out 8 to a row of the block tile (p0 = 4 (tid % 8)), so each of
// a step's four loads touches 4 (of a) or 8 (of b) distinct float4 in a
// warp: four 128-byte wavefronts of shared memory for 64 FMAs a thread.
template <int kLda, int kLdb, int kHalf, bool kScaled>
__device__ __forceinline__ void fma_8x8(float (&acc)[8][8], const float* a, const float* b,
                                        const float* scale, int i0, int p0, int kn) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 a0 = ld4(a + k * kLda + i0), a1 = ld4(a + k * kLda + i0 + kHalf);
    float4 b0 = ld4(b + k * kLdb + p0), b1 = ld4(b + k * kLdb + p0 + 32);
    if (kScaled) {
      const float s = scale[k];
      b0.x *= s; b0.y *= s; b0.z *= s; b0.w *= s;
      b1.x *= s; b1.y *= s; b1.z *= s; b1.w *= s;
    }
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// The row of a thread's 8 x 8 block held in acc[r] (r < 4: row i0 + r,
// else i0 + kHalf + r - 4), columns h * 32 + p0 .. + 3.
__device__ __forceinline__ float4 quad(const float (&acc)[8][8], int r, int h) {
  return make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
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

// ---- 1. acs (launched with 32 * kAcsWarps threads): one warp a (b, chunk, h) row; acs, dt and the chunk state's
// weight dt exp(acs_end - acs) of the row, each padded to qp floats with 0.
__device__ __forceinline__ void acs_phase(const float* __restrict__ dt, const float* __restrict__ a,
                                          float* __restrict__ ad, const Dims& d, const Strides& st) {
  const long long row = static_cast<long long>(blockIdx.x) * kAcsWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(d.B) * d.nc * d.H) return;     // the whole warp
  const int hh = static_cast<int>(row % d.H);
  const long long bc = row / d.H;
  const int c = static_cast<int>(bc % d.nc), b = static_cast<int>(bc / d.nc);
  const float* dtr = dt + b * st.dt_b + static_cast<long long>(c) * d.Q * st.dt_s + hh * st.dt_h;
  const float a_head = a[hh * st.a_h];
  float* acs = ad + row * 3 * d.qp;
  float* dts = acs + d.qp;
  float* ws = dts + d.qp;
  const int lane = threadIdx.x & 31;
  for (int t = lane; t < d.Q; t += 32) {
    const float v = dtr[static_cast<long long>(t) * st.dt_s];
    dts[t] = v;
    acs[t] = __fmul_rn(v, a_head);
  }
  __syncwarp();
  warp_cumsum(acs, d.Q);
  __syncwarp();
  const float acs_end = acs[d.Q - 1];
  for (int t = lane; t < d.Q; t += 32) ws[t] = __fmul_rn(dts[t], expf(acs_end - acs[t]));
  for (int t = d.Q + lane; t < d.qp; t += 32) acs[t] = dts[t] = ws[t] = 0.f;
}

// ---- 2. cb (kTileThreads threads): one block a (b, chunk, tile pair (t, s), s <= t):
// out[j][i] = C_{t0+i} . B_{s0+j}, zero past the chunk.
__device__ __forceinline__ void cb_phase(const float* __restrict__ bm, const float* __restrict__ cm,
                                         float* __restrict__ cb, const Dims& d, const Strides& st) {
  __shared__ __align__(16) float sB[kT * kT];      // [n][j]: B_j transposed
  __shared__ __align__(16) float sC[kT * kT];      // [n][i]: C_i transposed
  const long long blk = blockIdx.x;                // pair fastest, then chunk, then batch
  const int pair = static_cast<int>(blk % d.pairs);
  const long long bc = blk / d.pairs;
  const int c = static_cast<int>(bc % d.nc), b = static_cast<int>(bc / d.nc);
  int t = static_cast<int>((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while ((t + 1) * (t + 2) / 2 <= pair) ++t;
  while (t * (t + 1) / 2 > pair) --t;
  const int s = pair - t * (t + 1) / 2;
  const int t0 = t * kT, s0 = s * kT;
  const int rows = min(kT, d.Q - t0), cols = min(kT, d.Q - s0);
  const float* brow = bm + b * st.b_b + (static_cast<long long>(c) * d.Q + s0) * st.b_s;
  const float* crow = cm + b * st.c_b + (static_cast<long long>(c) * d.Q + t0) * st.c_s;
  const int tid = threadIdx.x, j0 = (tid / 8) * 4, i0 = (tid % 8) * 4;
  float acc[8][8] = {};
  for (int n0 = 0; n0 < d.N; n0 += kT) {
    const int kn = min(kT, d.N - n0);
    __syncthreads();                               // readers of the previous n-tile are done
    load_transposed<kT, kTileThreads>(sB, brow + n0, st.b_s, cols, kn);
    load_transposed<kT, kTileThreads>(sC, crow + n0, st.c_s, rows, kn);
    __syncthreads();
    fma_8x8<kT, kT, 32, false>(acc, sB, sC, nullptr, j0, i0, kn);
  }
  float* out = cb + (bc * d.pairs + pair) * kT * kT;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = j0 + (r < 4 ? r : 28 + r);
    st4(out + j * kT + i0, quad(acc, r, 0));
    st4(out + j * kT + i0 + 32, quad(acc, r, 1));
  }
}

// ---- 3. chunk_state (kStateThreads threads): one block a (b, chunk, h) and 128 state columns:
// S_c^T[n][p] = sum_s B_s[n] (x_s[p] w_s), the weights w_s of row (b, chunk,
// h) at w + row * w_row, zero past the chunk.  The forward's weights are
// dt exp(acs_end - acs) (B and x read through st's b_ and x_ strides); the
// backward runs it on C, dy and exp(acs) (csrc/ssd_scan_bwd.cu).
__device__ __forceinline__ void chunk_state_phase(const float* __restrict__ x, const float* __restrict__ bm,
                                                  const float* __restrict__ w, long long w_row,
                                                  float* __restrict__ sts, const Dims& d, const Strides& st) {
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);     // [2][kStateK][kStateRows]: B rows
  float* sX = sB + 2 * kStateK * kStateRows;       // [2][kStateK][kT]: x rows
  float* sW = sX + 2 * kStateK * kT;               // [2][kStateK]: the positions' weights
  const long long row = blockIdx.x;                // (b, chunk, h)
  const int hh = static_cast<int>(row % d.H);
  const long long bc = row / d.H;
  const int c = static_cast<int>(bc % d.nc), b = static_cast<int>(bc / d.nc);
  const int n_base = blockIdx.y * kStateRows, n_rows = min(kStateRows, d.N - n_base);
  const float* xr = x + b * st.x_b + static_cast<long long>(c) * d.Q * st.x_s + hh * st.x_h;
  const float* br = bm + b * st.b_b + static_cast<long long>(c) * d.Q * st.b_s + n_base;
  const float* ws = w + row * w_row;
  const int tid = threadIdx.x, n0 = (tid / 8) * 4, p0 = (tid % 8) * 4;

  auto stage = [&](int k0, int buf) {
    const int kr = min(kStateK, d.Q - k0);
    async_rows<kStateK, kStateRows, kStateThreads>(sB + buf * kStateK * kStateRows,
                                                   br + static_cast<long long>(k0) * st.b_s, st.b_s, kr,
                                                   n_rows);
    async_rows<kStateK, kT, kStateThreads>(sX + buf * kStateK * kT, xr + static_cast<long long>(k0) * st.x_s,
                                           st.x_s, kr, d.P);
    if (tid < kStateK / 4) cp_async16(sW + buf * kStateK + 4 * tid, ws + k0 + 4 * tid, true);
    cp_async_commit();
  };

  float acc[8][8] = {};
  const int nk = ceil_div(d.Q, kStateK);
  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    cp_async_wait_all();
    __syncthreads();                               // stage kt is in; readers of buffer buf ^ 1 are done
    if (kt + 1 < nk) stage((kt + 1) * kStateK, buf ^ 1);
    const int kr = min(kStateK, d.Q - kt * kStateK);
    fma_8x8<kStateRows, kT, kStateRows / 2, true>(acc, sB + buf * kStateK * kStateRows, sX + buf * kStateK * kT,
                                                  sW + buf * kStateK, n0, p0, (kr + 3) / 4 * 4);   // rows past kr are 0
  }
  float* out = sts + row * d.N * d.P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + (r < 4 ? r : kStateRows / 2 - 4 + r);
    if (n >= n_rows) continue;
    float* o = out + static_cast<long long>(n_base + n) * d.P;
    if (p0 < d.P) st4(o + p0, quad(acc, r, 0));
    if (p0 + 32 < d.P) st4(o + p0 + 32, quad(acc, r, 1));
  }
}

// The widths and chunk the kernels take, with every grid within 2^31 - 1 blocks.
bool valid(int B, int S, int H, int P, int N, int Q) {
  if (P < 4 || P > 64 || P % 4 != 0 || N < 4 || N > 256 || N % 4 != 0 || Q < 1 || S < Q || S % Q != 0 ||
      B < 1 || H < 1)
    return false;
  const Dims d = dims(B, S, H, P, N, Q);
  const long long rows = static_cast<long long>(B) * d.nc * H;      // each grid within 2^31 - 1 blocks
  return rows * d.nt < (1LL << 31) && static_cast<long long>(B) * d.nc * d.pairs < (1LL << 31) &&
         static_cast<long long>(B) * H * ceil_div(N, kPassN) < (1LL << 31);
}

}  // namespace
