// Mamba-2 SSD chunk scan (state-space duality, arXiv:2405.21060).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::
// ssd_scan_kernel (body _ssd_kernel).  The sequence of each (batch b,
// head h) is cut into chunks of Q positions.  With the log-decay
// la_t = dt_t * a and acs its inclusive cumulative sum inside the chunk,
//     y_t = sum_{s<=t} (C_t . B_s) exp(acs_t - acs_s) x_s dt_s      (intra-chunk)
//         + exp(acs_t) (C_t . h_in[p, :])                         (inter-chunk)
//     h_in[c+1] = exp(acs_{Q-1}) h_in[c] + S_c,
//     S_c = sum_s exp(acs_{Q-1} - acs_s) (x_s dt_s) (x) B_s,      h_in[0] = 0.
// Float32 throughout, no fast math.  acs is summed in float64 and rounded
// once to float32, as the plain version (kernels/ssd_scan/ref.py) does: at
// the serve shape it reaches about -2,200 at the end of a chunk of 1,024,
// where a float32 running sum would carry an error of ~1e-3 that depends
// on the order of the adds.  The decay is always expf of the float32
// difference acs_t - acs_s of one pair, never exp(acs_t) exp(-acs_s):
// exp(-acs_s) overflows float32 once acs passes -88.
//
// Bound on the H100: at the serve shape (B, S, H, P, N, Q) = (4, 8192, 32,
// 64, 128, 1024) the function needs about 1.1e11 float32 operations (the
// causal half of C B^T once per batch and chunk, since the heads share B
// and C; per head the decay, scores . x dt and the two state products),
// 1.6 ms at 67 TFLOP/s, against 0.17 ms to move its 0.58 GB: it is bound
// by operations.  The Pallas kernel walks the chunks of a (b, h) in order
// with the whole Q x Q decay matrix in VMEM, because a TPU grid runs in
// order.  Carried over as it was, that gave one block per (b, h): 128
// blocks at the serve shape and 16-32 at batch 1, each forming C B^T again
// for its head (2.5e11 operations issued).  Here only the state's carry is
// sequential; the chunks' own terms run in parallel, in five launches on
// the caller's stream (1.1e11 operations issued at the serve shape):
//   1. acs (ssd_scan_acs_kernel): one warp a (b, chunk, h) sums dt a in
//      float64 (warp_cumsum) into a scratch row padded with zeros to whole
//      tiles, beside a copy of dt and the chunk state's weight
//      dt exp(acs_end - acs), so that later phases copy all three with
//      cp.async.
//   2. cb (ssd_scan_cb_kernel): C B^T once a (b, chunk) for the 64 x 64
//      tiles on and below the diagonal, each stored transposed ([s][t]) and
//      zero past the chunk's end, for all heads (4.6e9 operations at the
//      serve shape, 1/32 of forming it per head).
//   3. chunk_state (ssd_scan_chunk_state_kernel): one block a (b, chunk,
//      h, 128 state columns) forms S_c^T [N][P] = B^T . (x dt exp(acs_end
//      - acs)), every chunk at once, from stages of 32 positions copied
//      with cp.async into a double buffer.
//   4. state_pass (ssd_scan_state_pass_kernel): one thread a few (b, h, n,
//      p) walks the chunks, h_in[c+1] = fmaf(exp(acs_end), h_in[c], S_c),
//      into a buffer of its own (written over S in place, the pass was
//      several times slower on the H100), and writes the final state.
//   5. chunk_scan (ssd_scan_chunk_scan_kernel): one block of 64 threads a
//      (b, chunk, h, 64-row tile t), B * nc * H * Q/64 blocks (16,384 at the
//      serve shape), head fastest so that the H blocks reading one cb tile
//      run together and find it in L2, and the heavy tiles (t high: t + 1
//      column tiles) first.  It starts the y tile with the inter-chunk
//      term, then walks the column tiles s <= t in stages of 32 positions:
//      the cb rows, x, acs and dt of the next stage are copied with
//      cp.async into one half of a double buffer while the other is in
//      use.  Each warp scales the score columns that only its own threads
//      read by exp(acs_t - acs_s) dt_s (0 above the diagonal and past the
//      chunk), so it waits for no other warp, and adds them times x_s into
//      the y tile.  No tile is skipped for a small decay.
// Every product runs on the CUDA cores with an 8 x 8 block of outputs a
// thread in registers: a step of the sum reads two float4 of each operand
// for 64 FMAs.  chunk_scan takes 33,536 bytes of shared memory and at most
// 170 registers a thread, so an SM holds 6 of its blocks (12 warps), by
// shared memory and registers alike; fully unrolled stages, a stage of 64
// positions (3 blocks an SM) or of 16 (spills) were slower on the H100.
// chunk_state takes 49,408 bytes a 128-thread block.  Scratch (from the
// wrapper, see ssd_scan_scratch_floats): acs, dt and weights 3 MB, cb tiles
// 71 MB and the chunk states and incoming states 34 MB each at the serve
// shape.  The exps of the decay (one a score and head) and the copies cost
// about a third of chunk_scan's time; the tensor cores (3xTF32) are later
// work.
//
// Layout: x [B, S, H, P], dt [B, S, H], B and C [B, S, N] and a [H] are
// read through strides (B and C have no head stride: the model's bc
// projection is shared by all heads, so every head reads the same rows);
// y is a contiguous [B, S, H, P] and the final state a contiguous
// [B, H, P, N].  The state starts at zero.  P and N are multiples of 4,
// P <= 64, N <= 256.
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

// ---- 1. acs: one warp a (b, chunk, h) row; acs, dt and the chunk state's
// weight dt exp(acs_end - acs) of the row, each padded to qp floats with 0.
__global__ void __launch_bounds__(32 * kAcsWarps)
ssd_scan_acs_kernel(const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ ad,
                    Dims d, Strides st) {
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

// ---- 2. cb: one block a (b, chunk, tile pair (t, s), s <= t):
// out[j][i] = C_{t0+i} . B_{s0+j}, zero past the chunk.
__global__ void __launch_bounds__(kTileThreads)
ssd_scan_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ cb,
                   Dims d, Strides st) {
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

// ---- 3. chunk_state: one block a (b, chunk, h) and 128 state columns:
// S_c^T[n][p] = sum_s B_s[n] (x_s[p] dt_s exp(acs_end - acs_s)).
__global__ void __launch_bounds__(kStateThreads)
ssd_scan_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                            const float* __restrict__ ad, float* __restrict__ sts, Dims d, Strides st) {
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);     // [2][kStateK][kStateRows]: B rows
  float* sX = sB + 2 * kStateK * kStateRows;       // [2][kStateK][kT]: x rows
  float* sW = sX + 2 * kStateK * kT;               // [2][kStateK]: dt exp(acs_end - acs)
  const long long row = blockIdx.x;                // (b, chunk, h)
  const int hh = static_cast<int>(row % d.H);
  const long long bc = row / d.H;
  const int c = static_cast<int>(bc % d.nc), b = static_cast<int>(bc / d.nc);
  const int n_base = blockIdx.y * kStateRows, n_rows = min(kStateRows, d.N - n_base);
  const float* xr = x + b * st.x_b + static_cast<long long>(c) * d.Q * st.x_s + hh * st.x_h;
  const float* br = bm + b * st.b_b + static_cast<long long>(c) * d.Q * st.b_s + n_base;
  const float* ws = ad + row * 3 * d.qp + 2 * d.qp;
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

// ---- 4. state_pass: one block a (b, h) and kPassN state rows n, each
// thread a few (n, p): h_in[c] in order, the next chunk's S read while this
// one's h_in is written, then the final state into h_out [B, H, P, N]
// through shared memory, so that its rows are written whole.
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_state_pass_kernel(const float* __restrict__ ad, const float* __restrict__ sts,
                           float* __restrict__ hin, float* __restrict__ h_out, Dims d) {
  constexpr int kPer = kPassN * kT / kPassThreads;        // (n, p) a thread at P = 64
  __shared__ float tile[kPassN][kT + 1];
  const int n_blocks = ceil_div(d.N, kPassN);
  const long long bh = blockIdx.x / n_blocks;
  const int n_base = (blockIdx.x - bh * n_blocks) * kPassN, n_rows = min(kPassN, d.N - n_base);
  const int hh = static_cast<int>(bh % d.H), b = static_cast<int>(bh / d.H);
  const long long np = static_cast<long long>(d.N) * d.P;
  const int cells = n_rows * d.P, tid = threadIdx.x;
  // (n, p) pairs n_base.. of chunk c's [N][P] state, in the (b, chunk, h) row layout
  auto at = [&](int c) { return ((static_cast<long long>(b) * d.nc + c) * d.H + hh) * np + n_base * d.P; };
  float h[kPer] = {}, cur[kPer] = {};
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (tid + u * kPassThreads < cells) cur[u] = sts[at(0) + tid + u * kPassThreads];
  for (int c = 0; c < d.nc; ++c) {
    float nxt[kPer] = {};
    if (c + 1 < d.nc) {
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (tid + u * kPassThreads < cells) nxt[u] = sts[at(c + 1) + tid + u * kPassThreads];
    }
    const long long row = (static_cast<long long>(b) * d.nc + c) * d.H + hh;
    const float decay = expf(ad[row * 3 * d.qp + d.Q - 1]);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int f = tid + u * kPassThreads;
      if (f < cells) {
        hin[at(c) + f] = h[u];
        h[u] = fmaf(decay, h[u], cur[u]);
      }
      cur[u] = nxt[u];
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int f = tid + u * kPassThreads;
    if (f < cells) tile[f / d.P][f % d.P] = h[u];
  }
  __syncthreads();
  float* out = h_out + bh * np + n_base;                  // [P][N] rows, columns n_base..
  for (int f = tid; f < cells; f += kPassThreads) {
    const int p = f / n_rows, n = f - p * n_rows;
    out[static_cast<long long>(p) * d.N + n] = tile[n][p];
  }
}

// ---- 5. chunk_scan: one block a (b, chunk, h, 64-row tile t); the y tile.
__global__ void __launch_bounds__(kTileThreads, kScanBlocks)
ssd_scan_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ cm,
                           const float* __restrict__ ad, const float* __restrict__ cb,
                           const float* __restrict__ hins, float* __restrict__ y, Dims d, Strides st) {
  extern __shared__ float4 smem4[];
  float* sL = reinterpret_cast<float*>(smem4);     // [2][kScanK][kT]: cb rows [s][t], then the decayed scores
  float* sX = sL + 2 * kScanK * kT;                // [2][kScanK][kT]: x rows [s][p]
  float* sAi = sX + 2 * kScanK * kT;               // [kT]: acs of the tile's rows
  float* sAj = sAi + kT;                           // [2][kScanK]: acs of the stage's columns
  float* sDj = sAj + 2 * kScanK;                   // [2][kScanK]: dt of the stage's columns
  long long blk = blockIdx.x;                      // head fastest, then (b, chunk), heavy tiles first
  const int hh = static_cast<int>(blk % d.H);
  blk /= d.H;
  const long long n_bc = static_cast<long long>(d.B) * d.nc;
  const long long bc = blk % n_bc;
  const int t = d.nt - 1 - static_cast<int>(blk / n_bc);
  const int c = static_cast<int>(bc % d.nc), b = static_cast<int>(bc / d.nc);
  const int t0 = t * kT, rows = min(kT, d.Q - t0);
  const long long row = bc * d.H + hh;
  const float* acs = ad + row * 3 * d.qp;
  const float* dts = acs + d.qp;
  const float* xr = x + b * st.x_b + static_cast<long long>(c) * d.Q * st.x_s + hh * st.x_h;
  const float* tiles = cb + (bc * d.pairs + t * (t + 1) / 2) * kT * kT;   // tile (t, s) at s * kT * kT
  const int tid = threadIdx.x, i0 = (tid / 8) * 4, p0 = (tid % 8) * 4;

  // stage g: positions jb .. jb + kScanK - 1 of column tile s = g / kScanStages
  auto stage = [&](int g, int buf) {
    const int s = g / kScanStages, jb = (g % kScanStages) * kScanK, s0 = s * kT + jb;
    async_rows<kScanK, kT, kTileThreads>(sL + buf * kScanK * kT,
                                         tiles + static_cast<long long>(s) * kT * kT + jb * kT, kT, kScanK, kT);
    async_rows<kScanK, kT, kTileThreads>(sX + buf * kScanK * kT, xr + static_cast<long long>(s0) * st.x_s,
                                         st.x_s, d.Q - s0, d.P);
    if (tid < kScanK / 4) cp_async16(sAj + buf * kScanK + 4 * tid, acs + s0 + 4 * tid, true);
    else if (tid < kScanK / 2)
      cp_async16(sDj + buf * kScanK + 4 * (tid - kScanK / 4), dts + s0 + 4 * (tid - kScanK / 4), true);
    cp_async_commit();
  };

  if (tid < kT / 4) cp_async16(sAi + 4 * tid, acs + t0 + 4 * tid, true);
  stage(0, 0);                                     // commits sAi with it

  float acc[8][8] = {};
  if (c > 0) {                                     // inter-chunk: exp(acs_t) C_t . h_in[c] (h_in[0] = 0)
    const float* hin = hins + row * d.N * d.P;     // [N][P]
    const float* crow = cm + b * st.c_b + (static_cast<long long>(c) * d.Q + t0) * st.c_s;
    float* sCt = sL + kScanK * kT;                 // the second halves of the buffers
    float* sH = sX + kScanK * kT;
    for (int n0 = 0; n0 < d.N; n0 += kScanK) {
      const int kn = min(kScanK, d.N - n0);
      if (n0 > 0) __syncthreads();                 // readers of the previous n-tile are done
      async_rows<kScanK, kT, kTileThreads>(sH, hin + static_cast<long long>(n0) * d.P, d.P, kn, d.P);
      cp_async_commit();
      load_transposed<kScanK, kTileThreads>(sCt, crow + n0, st.c_s, rows, kn);
      cp_async_wait_all();
      __syncthreads();
      fma_8x8<kT, kT, 32, false>(acc, sCt, sH, nullptr, i0, p0, kn);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + (r < 4 ? r : 28 + r);
      const float dec = i < rows ? expf(sAi[i]) : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] *= dec;
    }
  }

  // Warp w reads only the score columns 16 w .. 16 w + 15 and 32 + 16 w ..
  // 32 + 16 w + 15 (its threads' rows), so it scales those itself, lane l
  // one column, and waits for no other warp.
  const int lane = tid & 31, ti = (tid >> 5) * 16 + lane + (lane >= 16 ? 16 : 0);
  const int n_stages = (t + 1) * kScanStages;
  for (int g = 0; g < n_stages; ++g) {
    const int buf = g & 1;
    cp_async_wait_all();
    __syncthreads();                               // stage g is in; readers of buffer buf ^ 1 are done
    if (g + 1 < n_stages) stage(g + 1, buf ^ 1);
    const int s = g / kScanStages, jb = (g % kScanStages) * kScanK;
    // live columns of the stage for this lane's row: inside the chunk, and on the diagonal tile j <= i
    const int live = ti < rows ? max(0, min(d.Q - (s * kT + jb), s < t ? kScanK : ti - jb + 1)) : 0;
    float* L = sL + buf * kScanK * kT + ti;
    const float* aj = sAj + buf * kScanK;
    const float* dj = sDj + buf * kScanK;
    const float a_i = sAi[ti];
    if (live == kScanK) {                          // L[j][i] scales x_j into y_i
#pragma unroll 2
      for (int j = 0; j < kScanK; j += 4) {
        const float4 a4 = ld4(aj + j), d4 = ld4(dj + j);
        L[(j + 0) * kT] = L[(j + 0) * kT] * expf(a_i - a4.x) * d4.x;
        L[(j + 1) * kT] = L[(j + 1) * kT] * expf(a_i - a4.y) * d4.y;
        L[(j + 2) * kT] = L[(j + 2) * kT] * expf(a_i - a4.z) * d4.z;
        L[(j + 3) * kT] = L[(j + 3) * kT] * expf(a_i - a4.w) * d4.w;
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kScanK; ++j)
        L[j * kT] = j < live ? L[j * kT] * expf(a_i - aj[j]) * dj[j] : 0.f;
    }
    __syncwarp();
    const int kn = s < t ? kScanK : max(0, min(kScanK, i0 + 36 - jb));   // past the diagonal L is 0
    fma_8x8<kT, kT, 32, false>(acc, sL + buf * kScanK * kT, sX + buf * kScanK * kT, nullptr, i0, p0, kn);
  }

  const long long y_row = static_cast<long long>(d.H) * d.P;
  float* yr = y + (static_cast<long long>(b) * d.S + static_cast<long long>(c) * d.Q + t0) * y_row + hh * d.P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? r : 28 + r);
    if (i >= rows) continue;
    if (p0 < d.P) st4(yr + i * y_row + p0, quad(acc, r, 0));
    if (p0 + 32 < d.P) st4(yr + i * y_row + p0 + 32, quad(acc, r, 1));
  }
}

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

// The largest dynamic shared memory of any phase's launch, in bytes; it no
// longer depends on the widths or the chunk.
extern "C" long long ssd_scan_smem_bytes() {
  return static_cast<long long>(kScanSmem > kStateSmem ? kScanSmem : kStateSmem);
}

// Floats of scratch a launch needs (acs and dt, the cb tiles, the chunk
// states); -1 for a shape the kernels do not take.
extern "C" long long ssd_scan_scratch_floats(int B, int S, int H, int P, int N, int Q) {
  if (!valid(B, S, H, P, N, Q)) return -1;
  const Dims d = dims(B, S, H, P, N, Q);
  return ad_floats(d) + cb_floats(d) + 2 * st_floats(d);
}

// x, dt, bm (B), cm (C), a: float32 views read through the strides below
// (in elements; unit last stride for x, B and C, 16-byte aligned rows; B
// and C have no head stride, as every head reads the same rows); y a
// contiguous [B, S, H, P] and h_out a contiguous [B, H, P, N], the final
// state from a zero start; scratch a 16-byte aligned float32 buffer of
// ssd_scan_scratch_floats.  Q is the chunk length (S a multiple of it).
// Five launches on ``stream``; returns the first CUDA error (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* bm, const void* cm,
                            const void* a, void* y, void* h_out, void* scratch,
                            int B, int S, int H, int P, int N, int Q,
                            long long x_b, long long x_s, long long x_h,
                            long long dt_b, long long dt_s, long long dt_h,
                            long long b_b, long long b_s, long long c_b, long long c_s,
                            long long a_h, void* stream) {
  if (!valid(B, S, H, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s, a_h};
  const Dims d = dims(B, S, H, P, N, Q);
  const Scratch sc = carve(static_cast<float*>(scratch), d);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(cm);
  const long long rows = static_cast<long long>(B) * d.nc * H;
  cudaError_t err;

  ssd_scan_acs_kernel<<<static_cast<unsigned>(ceil_div(static_cast<int>(rows), kAcsWarps)), 32 * kAcsWarps, 0,
                        s>>>(static_cast<const float*>(dt), static_cast<const float*>(a), sc.ad, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_scan_cb_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * d.nc * d.pairs), kTileThreads, 0, s>>>(
      bf, cf, sc.cb, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(ssd_scan_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kStateSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_chunk_state_kernel<<<dim3(static_cast<unsigned>(rows), ceil_div(N, kStateRows)), kStateThreads,
                                kStateSmem, s>>>(xf, bf, sc.ad, sc.st, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_scan_state_pass_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * H * ceil_div(N, kPassN)),
                               kPassThreads, 0, s>>>(sc.ad, sc.st, sc.hin, static_cast<float*>(h_out), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(ssd_scan_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kScanSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_chunk_scan_kernel<<<static_cast<unsigned>(rows * d.nt), kTileThreads, kScanSmem, s>>>(
      xf, cf, sc.ad, sc.cb, sc.hin, static_cast<float*>(y), d, st);
  return static_cast<int>(cudaGetLastError());
}
