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
//      several times slower on the H100), and writes the final state.  When
//      an input needs a gradient the wrapper hands it the caller's buffer
//      (ssd_scan_fwd's h_in), which the backward reads: 8.4 MB a layer at
//      (1, 8192, 32, 64, 128, Q 1024).
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
// Phases 1-3 and the tile helpers live in csrc/ssd_scan.cuh, shared with
// the backward (csrc/ssd_scan_bwd.cu).  Every product runs on the CUDA cores with an 8 x 8 block of outputs a
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
#include "ssd_scan.cuh"

namespace {

// The shared phases (ssd_scan.cuh) under the forward's kernel names.
__global__ void __launch_bounds__(32 * kAcsWarps)
ssd_scan_acs_kernel(const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ ad, Dims d,
                    Strides st) {
  acs_phase(dt, a, ad, d, st);
}

__global__ void __launch_bounds__(kTileThreads)
ssd_scan_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ cb, Dims d,
                   Strides st) {
  cb_phase(bm, cm, cb, d, st);
}

__global__ void __launch_bounds__(kStateThreads)
ssd_scan_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ bm, const float* __restrict__ w,
                            long long w_row, float* __restrict__ sts, Dims d, Strides st) {
  chunk_state_phase(x, bm, w, w_row, sts, d, st);
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
// h_in, where it is not null, is a contiguous [B, nc, H, N, P] that
// receives each chunk's incoming state (transposed, as the scratch holds
// it) for the backward; null (a serve) keeps them in the scratch.
// Five launches on ``stream``; returns the first CUDA error (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* bm, const void* cm,
                            const void* a, void* y, void* h_out, void* h_in, void* scratch,
                            int B, int S, int H, int P, int N, int Q,
                            long long x_b, long long x_s, long long x_h,
                            long long dt_b, long long dt_s, long long dt_h,
                            long long b_b, long long b_s, long long c_b, long long c_s,
                            long long a_h, void* stream) {
  if (!valid(B, S, H, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s, a_h};
  const Dims d = dims(B, S, H, P, N, Q);
  const Scratch sc = carve(static_cast<float*>(scratch), d);
  float* hin = h_in != nullptr ? static_cast<float*>(h_in) : sc.hin;
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
                                kStateSmem, s>>>(xf, bf, sc.ad + 2 * d.qp, 3LL * d.qp, sc.st, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_scan_state_pass_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * H * ceil_div(N, kPassN)),
                               kPassThreads, 0, s>>>(sc.ad, sc.st, hin, static_cast<float*>(h_out), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(ssd_scan_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kScanSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_chunk_scan_kernel<<<static_cast<unsigned>(rows * d.nt), kTileThreads, kScanSmem, s>>>(
      xf, cf, sc.ad, sc.cb, hin, static_cast<float*>(y), d, st);
  return static_cast<int>(cudaGetLastError());
}
